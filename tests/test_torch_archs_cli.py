"""The launchers on the new architectures, on the CPU: the serve CLI's
greedy decode of the smoke Mamba2 and pruned-FFN scoring of the smoke
RecurrentGemma, its refusal of embeddings-input archs, and the train CLI
on the smoke RecurrentGemma (hybrid blocks, local attention) and MusicGen
(embedding inputs, sinusoidal positions, LayerNorm)."""
import pytest

pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402


def test_serve_generates_mamba2_smoke_on_cpu(capsys):
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--batch", "2",
            "--prompt-len", "12", "--gen", "4", "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "generated (2, 16) in " in out and "tok/s" in out


def test_serve_prunes_recurrentgemma_smoke_on_cpu(capsys):
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--prune-ffn", "0.25", "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "pruned 5 MLPs" in out
    assert "plans built during serving: 0" in out


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-76b"])
def test_serve_refuses_embeddings_archs(arch):
    with pytest.raises(SystemExit, match="embeddings-mode"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "musicgen-large"])
def test_train_cli_smoke_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--global-batch",
            "2", "--seq-len", "16", "--log-every", "1", "--device", "cpu"]
    assert train.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2
    assert all("loss=nan" not in ln for ln in lines)
