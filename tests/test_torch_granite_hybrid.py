"""Granite-4.0-H-Micro in the port against the benchmark's plain reference
(``bench/archs/granitemoehybrid/reference.py``, loaded by path), on the
CPU at smoke widths: the SSD mixer and its state carried across chunks,
the conv bias, the gated norm, NoPE and the score scale, the µP
multipliers, the whole pruned forward through ``make_pruned_forward`` and
a ``serving.Server`` bucket; the knobs left at their defaults compute
what a plain config does, bit for bit; ``check_prunable`` takes the
hybrid and refuses pure SSD and MoE; and each fault planted in the port
fails the configuration's limits.

The reference imports nothing of the program; its weights are the
benchmark's (``weights.make``), handed to the port as its parameter tree.
f32 compute isolates the algorithm (2e-5, the port's f32 bar): a knob
turned off, or a planted fault, moves the logits by more than ``OFF``
relative, 50 times that bar.  bf16 is held at the configuration's own
limits, as the benchmark holds it; there random weights hide some faults
(under the 1/64 score multiplier random queries and keys attend almost
uniformly, so RoPE in a NoPE layer moves the smoke model's f32 logits
by 2.5e-3 of their norm), and ``bench/tests`` plants at those limits the
faults they catch.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import (ARCHS, HybridConfig, get_config,  # noqa
                                 get_smoke_config)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.serving import BucketLadder, Server  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = ROOT / "bench" / "archs" / "granitemoehybrid"
NAME = "granite-4.0-h-micro"
F32 = dict(rtol=2e-5, atol=2e-5)
OFF = 1e-3


def _load(part: str):
    """``bench/archs/granitemoehybrid/<part>.py`` under a name of its own,
    kept in ``sys.modules`` (a dataclass looks its module up there)."""
    name = f"granitemoehybrid_{part}_under_test"
    spec = importlib.util.spec_from_file_location(name, ARCH / f"{part}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


REF = _load("reference")
WEIGHTS = _load("weights")
LIMITS = json.loads((ROOT / "bench" / "configs" /
                     "granite-4-h-micro.json").read_text())["limits"]


def bench_cfg(**over) -> dict:
    """The benchmark's configuration file cut to its smoke size."""
    cfg = json.loads((ROOT / "bench" / "configs" /
                      "granite-4-h-micro.json").read_text())
    cfg.update(WEIGHTS.SMOKE, **over)
    return cfg


def port_cfg(compute="float32", **over) -> HybridConfig:
    return dataclasses.replace(get_smoke_config(NAME), compute_dtype=compute,
                               **over)


def port_params(w: dict) -> dict:
    """The benchmark's weights as the port's parameter tree."""
    blocks = []
    for lw in w["layers"]:
        blk = {"ln1": {"scale": lw["ln1"]}, "ln2": {"scale": lw["ln2"]},
               "mlp": {k: lw[k] for k in ("w1", "w3", "w2")}}
        if "in_proj" in lw:
            blk["ssd"] = {k: lw[k] for k in (
                "in_proj", "conv", "conv_bias", "a_log", "dt_bias", "d_skip",
                "norm", "out_proj") if k in lw}
        else:
            blk["attn"] = {k: lw[k] for k in ("wq", "wk", "wv", "wo")}
        blocks.append(blk)
    return {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]},
            "blocks": blocks}


def tokens(b=2, s=40, seed=3, vocab=512):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


def worst(served, ref_logits) -> dict:
    """The benchmark's two numbers (``bench/check.py``), worst over the
    positions of every row."""
    err = gap = 0.0
    for s, r in zip(served, ref_logits):
        e = (s - r).norm(dim=-1) / r.norm(dim=-1)
        pick = s.argmax(-1, keepdim=True)
        g = (r.amax(-1) - r.gather(-1, pick)[:, 0]) / r.std(-1)
        err, gap = max(err, float(e.max())), max(gap, float(g.max()))
    return {"logit_err": err, "top1_gap": gap}


def passes(w: dict) -> bool:
    return all(w[k] <= LIMITS[k] for k in LIMITS)


def pruned_logits(mc, w, toks):
    params = port_params(w)
    blocks = serve.prune_ffn_blocks(params, mc, 0.25)
    with torch.no_grad():
        return serve.make_pruned_forward(mc)(params, blocks, toks)


def reference_logits(w, toks, cfg=None):
    return REF.score(w, cfg or bench_cfg(), list(toks))


# ------------------------------------------------------- configuration ---


def test_smoke_config_is_the_benchmarks_cut():
    mc, cfg = get_smoke_config(NAME), bench_cfg()
    kinds = {"mamba": "ssd_mlp", "attention": "attn"}
    assert mc.block_types() == [kinds[k] for k in cfg["layer_types"]]
    assert (mc.d_model, mc.num_heads, mc.num_kv_heads, mc.d_ff,
            mc.vocab_size) == (cfg["hidden_size"], cfg["num_attention_heads"],
                               cfg["num_key_value_heads"],
                               cfg["shared_intermediate_size"],
                               cfg["vocab_size"])
    assert (mc.ssm_state, mc.ssm_head_dim, mc.ssm_chunk, mc.conv_width) == (
        cfg["mamba_d_state"], cfg["mamba_d_head"], cfg["mamba_chunk_size"],
        cfg["mamba_d_conv"])
    assert (mc.norm_eps, mc.embedding_multiplier, mc.attention_multiplier,
            mc.residual_multiplier, mc.logits_scaling) == (
        cfg["rms_norm_eps"], cfg["embedding_multiplier"],
        cfg["attention_multiplier"], cfg["residual_multiplier"],
        cfg["logits_scaling"])


def test_published_config_is_port_only():
    mc = get_config(NAME)
    assert NAME not in ARCHS
    assert mc.block_types().count("attn") == 4
    assert [i for i, b in enumerate(mc.block_types()) if b == "attn"] == \
        [5, 15, 25, 35]
    assert mc.ssm_expand * mc.d_model // mc.ssm_head_dim == 64
    assert mc.nope and mc.ssm_conv_bias and mc.ssm_gated_norm


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_knobs_at_their_defaults_are_bit_identical(arch):
    """A HybridConfig that sets no knob computes what the plain config
    does, bit for bit, through every block type the arch has."""
    plain = dataclasses.replace(get_smoke_config(arch),
                                compute_dtype="bfloat16")
    fields = {f.name: getattr(plain, f.name)
              for f in dataclasses.fields(plain)}
    hybrid = HybridConfig(**fields)
    params = M.init_params(plain, 4, "cpu")
    toks = tokens(vocab=plain.vocab_size, s=24)
    with torch.no_grad():
        want = M.prefill(params, plain, {"tokens": toks})[1]
        got = M.prefill(params, hybrid, {"tokens": toks})[1]
    assert torch.equal(got, want)


# ------------------------------------------------------------ the mixer ---


@pytest.mark.parametrize("block", [4, 8, 64])
def test_reference_blocks_are_the_loop(block):
    """The reference's blockwise recurrence against its step-by-step loop,
    over a length that leaves a partial last block."""
    g = torch.Generator().manual_seed(11)
    s, h, p, n = 37, 3, 4, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 3 - 0.1
    b, c = torch.randn(s, n, generator=g), torch.randn(s, n, generator=g)
    want = REF.ssd_loop(x, dt, a, b, c)
    torch.testing.assert_close(REF.ssd_blocks(x, dt, a, b, c, block), want,
                               **F32)


@pytest.mark.parametrize("scan", ["ssd_blocks", "ssd_loop"])
def test_the_f32_control_rounds_the_scan_and_the_gated_norm(scan):
    """The configuration states the scan's sums and state and the gated
    norm in float32, so the control that lowers the float32 points
    (``control="f32"``) rounds them: the mixer moves, by a rounding."""
    cfg = bench_cfg()
    w = WEIGHTS.make(cfg, 5, "cpu")
    a = torch.randn(29, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    run = getattr(REF, scan)
    sound, lowered = (REF.mamba_mixer(a, w["layers"][0], cfg,
                                      REF.Precision.of(cfg, control),
                                      scan=run)
                      for control in (False, "f32"))
    moved = ((lowered - sound).norm() / sound.norm()).item()
    assert 0.0 < moved < 2e-2


def test_port_scan_carries_the_state_across_chunks():
    """``ssd_scan_chunked`` over five chunks against the reference's loop,
    head by head; the chunks alone (no state carried) do not match."""
    g = torch.Generator().manual_seed(12)
    s, h, p, n, chunk = 40, 3, 4, 5, 8
    x = torch.randn(1, s, h, p, generator=g)
    dt = torch.rand(1, s, h, generator=g) * 0.3
    a = -torch.rand(h, generator=g) - 0.05
    b, c = torch.randn(1, s, n, generator=g), torch.randn(1, s, n, generator=g)
    y, _ = S.ssd_scan_chunked(x, dt, a, b, c, chunk=chunk)
    want = REF.ssd_loop(x[0], dt[0], a, b[0], c[0])
    torch.testing.assert_close(y[0], want, **F32)
    alone = torch.cat([REF.ssd_loop(x[0, i:i + chunk], dt[0, i:i + chunk], a,
                                    b[0, i:i + chunk], c[0, i:i + chunk])
                       for i in range(0, s, chunk)])
    assert (alone - want).abs().max() > 1e-2


def _mixer_pair(**over):
    """The port's SSD mixer and the reference's over the same weights and
    normed input, f32."""
    cfg, mc = bench_cfg(), port_cfg(**over)
    w = WEIGHTS.make(cfg, 5, "cpu")
    lw = w["layers"][0]
    a = torch.randn(2, 29, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    p = port_params(w)["blocks"][0]["ssd"]
    with torch.no_grad():
        got, _ = S.ssd_apply(p, a, mc)
    prec = REF.Precision.of(cfg)
    want = torch.stack([REF.mamba_mixer(x, lw, cfg, prec, scan=REF.ssd_loop)
                        for x in a])
    return got, want


def test_ssd_mixer_is_the_reference():
    """in_proj, the conv with its bias, the scan, D, the gated RMSNorm and
    out_proj, over a length that pads the last chunk."""
    got, want = _mixer_pair()
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("knob", ["ssm_conv_bias", "ssm_gated_norm"])
def test_ssd_mixer_knob_off_is_not_the_reference(knob):
    """The conv bias and the gated norm each change the mixer: with the
    knob off (its parameter left out, or the plain gate) the port no
    longer matches."""
    if knob == "ssm_conv_bias":
        cfg, mc = bench_cfg(), port_cfg()
        w = WEIGHTS.make(cfg, 5, "cpu")
        p = dict(port_params(w)["blocks"][0]["ssd"])
        del p["conv_bias"]
        a = torch.randn(1, 29, cfg["hidden_size"],
                        generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            got = S.ssd_apply(p, a, mc)[0]
        want = REF.mamba_mixer(a[0], w["layers"][0], cfg,
                               REF.Precision.of(cfg))[None]
    else:
        got, want = _mixer_pair(ssm_gated_norm=False)
    assert (got - want).norm() / want.norm() > OFF


def test_nope_attention_with_the_score_scale_is_the_reference():
    cfg, mc = bench_cfg(), port_cfg()
    w = WEIGHTS.make(cfg, 7, "cpu")
    lw = w["layers"][2]
    a = torch.randn(2, 21, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(8))
    p = port_params(w)["blocks"][2]["attn"]
    prec = REF.Precision.of(cfg)
    want = torch.stack([REF.attention_mixer(x, lw, cfg, prec) for x in a])
    with torch.no_grad():
        got = L.attention_apply(p, a, mc)[0]
        rope = L.attention_apply(p, a, dataclasses.replace(mc, nope=False))[0]
        unscaled = L.attention_apply(
            p, a, dataclasses.replace(mc, attention_multiplier=0.0))[0]
    torch.testing.assert_close(got, want, **F32)
    for other in (rope, unscaled):
        assert (other - want).norm() / want.norm() > OFF


def test_the_decode_step_takes_the_score_scale():
    """One-token attention against a cache scales its scores as the
    prefill does: the last position of a prefill equals a decode step."""
    mc = port_cfg()
    g = torch.Generator().manual_seed(9)
    q = torch.randn(1, 6, 4, 16, generator=g)
    k, v = torch.randn(1, 6, 2, 16, generator=g), torch.randn(1, 6, 2, 16,
                                                              generator=g)
    full = L.causal_attention(q, k, v, scale=mc.attention_multiplier)
    step = L.decode_attention(q[:, -1:], k, v, torch.tensor([5]),
                              scale=mc.attention_multiplier)
    torch.testing.assert_close(step[:, 0], full[:, -1], **F32)


# ------------------------------------------------------ the whole model ---


def test_pruned_forward_is_the_reference_at_float32():
    cfg = bench_cfg()
    w = WEIGHTS.make(cfg, 13, "cpu")
    toks = tokens()
    got = pruned_logits(port_cfg(), w, toks)
    want = reference_logits(w, toks)
    torch.testing.assert_close(got, torch.stack(want), **F32)


def test_server_bucket_is_the_reference_within_the_limits():
    """A ragged pair of prompts packed into one bucket of the server over
    the bf16 pruned forward: each row's logits against the reference's of
    its prompt alone, at the configuration's limits."""
    cfg, mc = bench_cfg(), port_cfg("bfloat16")
    w = WEIGHTS.make(cfg, 14, "cpu")
    params = port_params(w)
    blocks = serve.prune_ffn_blocks(params, mc, cfg["keep"])
    base = serve.make_pruned_forward(mc)
    srv = Server(lambda st, t: base(st[0], st[1], t), (params, blocks),
                 BucketLadder(lengths=(32,), batches=(2,)), name="t.hybrid")
    srv.warmup()
    prompts = [tokens(1, 32, seed=15)[0], tokens(1, 19, seed=16)[0]]
    mat = torch.zeros(2, 32, dtype=torch.int64)
    for i, p in enumerate(prompts):
        mat[i, :len(p)] = p
    out = srv.program(2, 32)(mat)
    served = [out[i, :len(p)] for i, p in enumerate(prompts)]
    got = worst(served, reference_logits(w, prompts))
    assert passes(got), got
    srv.stop(timeout=60)


def test_check_prunable_takes_the_hybrid_and_refuses_ssd_and_moe():
    serve.check_prunable(get_smoke_config(NAME))
    serve.check_prunable(get_config(NAME))
    for arch in ("mamba2-1.3b", "mixtral-8x22b", "olmoe-1b-7b"):
        with pytest.raises(SystemExit, match="SSD cores"):
            serve.check_prunable(get_smoke_config(arch))


def test_decode_steps_continue_the_prefill():
    """Prefill then one-token steps through the SSD and attention caches
    (conv state with its bias, SSM state, KV under NoPE and the score
    scale) give the logits of a whole forward at each position."""
    mc = port_cfg()
    params = M.init_params(mc, 3, "cpu")
    toks = tokens(2, 20, seed=19)
    with torch.no_grad():
        caches, _, pos = M.prefill(params, mc, {"tokens": toks[:, :17]},
                                   cache_len=24)
        steps = []
        for t in range(17, 20):
            logits, caches = M.decode_step(params, mc, caches,
                                           {"tokens": toks[:, t:t + 1]}, pos)
            steps.append(logits[:, 0])
            pos = pos + 1
        whole = [M.prefill(params, mc, {"tokens": toks[:, :t + 1]})[1][:, 0]
                 for t in range(17, 20)]
    torch.testing.assert_close(torch.stack(steps), torch.stack(whole),
                               rtol=1e-4, atol=1e-4)


def test_serve_cli_runs_the_hybrid(capsys):
    serve.main(["--arch", NAME, "--smoke", "--prune-ffn", "0.25",
                "--batch", "2", "--prompt-len", "16", "--device", "cpu"])
    assert "plans built during serving: 0" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [NAME, "granite-3-2b", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_mixers_run_in_spans_while_tracing(arch):
    """Every block's mixer runs in an ``obs.span`` named by its kind, the
    hybrid's and every other model's; with tracing off nothing more is
    recorded."""
    mc = get_smoke_config(arch)
    params = M.init_params(mc, 2, "cpu")
    batch = {"tokens": tokens(1, 16, vocab=mc.vocab_size)}
    with obs.tracing() as tr, torch.no_grad():
        M.prefill(params, mc, batch)
    kind = {"attn": "attention", "ssd": "ssd_mixer", "ssd_mlp": "ssd_mixer",
            "rglru": "rglru_mixer"}
    want = sorted(kind[b] for b in mc.block_types())
    assert sorted(e["name"] for e in tr.events(cat="model")) == want
    with torch.no_grad():
        M.prefill(params, mc, batch)                         # tracing off
    assert len(tr.events(cat="model")) == len(want)


# ----------------------------------------------------- planted faults ---


def _drop_inter_chunk(monkeypatch):
    scan = S.ssd_scan_chunked

    def alone(x, dt, a, b, c, *, chunk, mac_dtype=None):
        bs, s, h, p = x.shape
        nc = s // chunk
        y, st = scan(x.reshape(bs * nc, chunk, h, p),
                     dt.reshape(bs * nc, chunk, h), a,
                     b.reshape(bs * nc, chunk, -1),
                     c.reshape(bs * nc, chunk, -1), chunk=chunk,
                     mac_dtype=mac_dtype)
        return y.reshape(bs, s, h, p), st[-bs:]

    monkeypatch.setattr(S, "ssd_scan_chunked", alone)
    return {}


FAULTS = {
    "inter_chunk_state_dropped": _drop_inter_chunk,
    "gated_norm_dropped": lambda mp: {"ssm_gated_norm": False},
    "conv_bias_dropped": lambda mp: {"ssm_conv_bias": None},
    "residual_multiplier_dropped": lambda mp: {"residual_multiplier": 1.0},
    "rope_in_a_nope_layer": lambda mp: {"nope": False},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_against_the_reference(fault, monkeypatch):
    """Each fault planted in the port's f32 pruned forward moves its
    logits off the reference's by more than ``OFF``, where the sound
    forward holds the f32 bar, over two prompts of 64 tokens (8 chunks)."""
    cfg = bench_cfg()
    w = WEIGHTS.make(cfg, 17, "cpu")
    toks = tokens(2, 64, seed=18)
    ref = reference_logits(w, toks)
    sound = worst(pruned_logits(port_cfg(), w, toks), ref)
    assert sound["logit_err"] < 1e-5, sound
    over = FAULTS[fault](monkeypatch)
    if over.pop("ssm_conv_bias", 0) is None:
        for lw in w["layers"]:
            lw.pop("conv_bias", None)
    got = worst(pruned_logits(port_cfg(**over), w, toks), ref)
    assert got["logit_err"] > OFF, (fault, got, sound)
