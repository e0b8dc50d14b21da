"""The granitemoehybrid architecture in the benchmark: its operations
counted by hand, its row-split launches the dense list, the mixer
readings fenced by those launches on a synthetic device trace, faults
planted in the served program failing ``correct`` on the smoke cell, and
(``-m cuda``) the smoke cell run on the card."""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

import devtrace
import harness
import mixers
import system
from conftest import BENCH, CELLS, DENSE

HYB = harness.Arch.load(BENCH, "granitemoehybrid")
SEED = 2 ** 31 + 41
LONG = "granite-4-h-micro-smoke.score-long"
# Two layers, a Mamba2 mixer then NoPE attention: d 4, ff 8, 2 heads of 2
# with 1 kv head, d_inner 8 in 2 heads of 4, d_state 3, conv 2, chunks of
# 2, vocabulary 10, keep 0.5.
TINY = dict(hidden_size=4, intermediate_size=8, shared_intermediate_size=8,
            num_attention_heads=2, num_key_value_heads=1, vocab_size=10,
            num_hidden_layers=2, layer_types=["mamba", "attention"],
            mamba_expand=2, mamba_n_heads=2, mamba_d_head=4,
            mamba_d_state=3, mamba_chunk_size=2, mamba_d_conv=2, keep=0.5)


def test_request_flops_by_hand():
    # 3 tokens.  FFN: w1, w3 8 rows x 2 kept, w2 4 rows x 4 kept = 48
    # nonzeros, 2 * 48 * 3 = 288 a layer, 576 for both.  Mamba2: in_proj
    # 2 * 4 * (8 + 8 + 6 + 2) * 3 = 576; conv 2 * 2 * 14 * 3 = 168; in the
    # chunks of 2, 3 + 1 = 4 causal pairs: scores 2 * 3 * 4 = 24, sums
    # 2 * 2 * 4 * 4 = 64; states and outputs 2 * 2 * 4 * 3 * (2 * 3 + 2
    # chunks) = 384, D 2 * 8 * 3 = 48; gated norm 5 * 8 * 3 = 120;
    # out_proj 2 * 8 * 4 * 3 = 192: 1576.  Attention: projections 2 *
    # (16 + 16 + 8 + 8) * 3 = 288, 6 pairs x 2 heads x 2 dims x 2 x 2 =
    # 96: 384.  Logits 2 * 4 * 10 * 3 = 240.
    assert HYB.counts.request_flops(TINY, 3) == 576 + 1576 + 384 + 240


def test_causal_pairs_in_chunks():
    assert HYB.counts.causal_pairs(3, 2) == 3 + 1
    assert HYB.counts.causal_pairs(4096, 256) == 16 * 256 * 257 // 2
    assert HYB.counts.causal_pairs(5, 8) == 15


def test_spmm_launches_are_the_dense_list():
    """The 120 pruned matrices have Granite-3.0-2B's FFN shapes, so one
    forward launches the same row-split list as ``granite-3-2b``."""
    cfg = CELLS.config("granite-4-h-micro")
    launches = HYB.counts.spmm_launches(cfg)
    assert launches == DENSE.counts.spmm_launches(cfg)
    assert launches == DENSE.counts.spmm_launches(
        CELLS.config("granite-3-2b"))
    assert len(launches) == 3 * len(HYB.counts.layer_kinds(cfg)) == 120


# ------------------------------------------------------------- fences ---

KINDS = ["mamba", "attention", "mamba"]
FENCE_CFG = dict(TINY, num_hidden_layers=3, layer_types=KINDS)


def synthetic_call(t: int, mixer_ns: list) -> tuple[list, int]:
    """One call's device operations from ``t`` (ns): the tokens copy, then
    for each layer its mixer (two kernels of ``mixer_ns[i]`` together, a
    1 ns bubble between) and its three row-split launches of 10 ns, each
    followed by a 1 ns elementwise kernel; then the logits, 50 ns."""
    ops = [("Memcpy HtoD (Pageable -> Device)", t, t + 3)]
    t += 5
    for ns in mixer_ns:
        half = ns // 2
        ops += [("mixer_a", t, t + half), ("mixer_b", t + half + 1,
                                           t + ns + 1)]
        t += ns + 1
        for name in ("w1", "w3", "w2"):
            ops += [(f"void repro::rowsplit_kernel<{name}>", t, t + 10),
                    ("elementwise", t + 10, t + 11)]
            t += 11
    ops.append(("gemm_logits", t, t + 50))
    return ops, t + 50


def fence_window(calls, window=None, *, per_call=None):
    device, t, shapes = [], 100, []
    for mixer_ns in calls:
        ops, t = synthetic_call(t, mixer_ns)
        device += ops
        shapes.append((1, 4))
        t += 20
    tr = devtrace.DeviceTrace(device, [], window or (0, t))
    counts = HYB.counts
    if per_call is not None:
        counts = SimpleNamespace(layer_kinds=counts.layer_kinds,
                                 spmm_launches=lambda cfg: [None] * per_call)
    arch = SimpleNamespace(counts=counts)
    return SimpleNamespace(traced=SimpleNamespace(
        trace=tr, arch=arch, config=FENCE_CFG, calls=shapes))


def test_fenced_segments_sum_each_kinds_mixers():
    # a layer's segment: the previous w2's elementwise kernel (1 ns) and
    # its mixer; layer 0's from the end of the tokens copy: a 2 ns gap
    # then the mixer.
    win = fence_window([[40, 30, 60], [44, 32, 62]])
    assert mixers.segments_ms(win, "mamba") == [(40 + 1 + 60) / 1e6,
                                                (44 + 1 + 62) / 1e6]
    assert mixers.segments_ms(win, "attention") == [31 / 1e6, 33 / 1e6]
    assert mixers.mixer_ms(win, "attention") == pytest.approx(32 / 1e6)


def test_fences_skip_calls_outside_the_window_and_refuse_miscounts():
    win = fence_window([[40, 30, 60], [44, 32, 62]], window=(0, 500))
    assert mixers.segments_ms(win, "mamba") == [101 / 1e6]
    assert mixers.mixer_ms(fence_window([[4, 3, 6]], per_call=8),
                           "mamba") is None
    win.traced.arch = SimpleNamespace(counts=DENSE.counts)
    assert mixers.mixer_ms(win, "mamba") is None


def test_a_call_without_its_tokens_copy_is_skipped():
    win = fence_window([[40, 30, 60], [44, 32, 62]])
    tr = win.traced.trace
    tr.device = [e for e in tr.device if e[1] < 200 or "HtoD" not in e[0]]
    assert mixers.segments_ms(win, "mamba") == [101 / 1e6]


# ----------------------------------------------------- planted faults ---


def faulty_build(**over):
    """The granitemoehybrid ``system.build`` with the port's config
    changed by ``over``: a fault planted in the served program."""
    from repro_torch.launch import serve

    def build(cfg, w, traffic):
        mc = dataclasses.replace(HYB.system.model_config(cfg), **over)
        params = HYB.system.port_params(w)
        blocks = serve.prune_ffn_blocks(params, mc, cfg["keep"])
        base = serve.make_pruned_forward(mc)
        return system.serve(lambda st, t: base(st[0], st[1], t),
                            (params, blocks), traffic)
    return build


def run(root, *, build=None, trace=False, seconds=1.5):
    return harness.run_cell(harness.Cells(root), LONG, seed=SEED,
                            seconds=seconds, trace=trace, device="cpu",
                            t_start=0.0, build=build)


def test_the_smoke_cell_is_correct_and_reports_its_metrics(root):
    # long enough for calls to complete inside the window on a busy host
    out = run(root, trace=True, seconds=4.0)
    assert out["correct"], out["compared"]
    assert {"step.mfu_calls.backlog", "step.mfu.backlog",
            "serve.host_gap_share.backlog", "device.idle_share.backlog"} <= \
        set(out["metrics"])


@pytest.mark.parametrize("over", [{"ssm_gated_norm": False},
                                  {"residual_multiplier": 1.0},
                                  {"logits_scaling": 1.0},
                                  {"embedding_multiplier": 1.0}],
                         ids=lambda o: next(iter(o)))
def test_a_planted_fault_is_not_correct(root, over):
    out = run(root, build=faulty_build(**over))
    assert not out["correct"], out["compared"]


@pytest.mark.cuda
def test_the_smoke_cell_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    out = harness.run_cell(harness.Cells(root), LONG, seed=SEED,
                           seconds=3.0, trace=True, device="cuda",
                           t_start=0.0)
    assert out["correct"], out["compared"]
    m = out["metrics"]
    assert {"step.mfu_calls.backlog", "step.mfu.backlog",
            "serve.host_gap_share.backlog",
            "device.idle_share.backlog"} <= set(m)
    if "kernel.rowsplit_roofline.backlog" in m:
        assert {"mixer.ssd_ms.long", "mixer.attn_ms.long"} <= set(m)
