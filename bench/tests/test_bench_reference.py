"""Each configuration's plain reference against the port on the CPU, on
its smoke variant: the same logits at float32 compute, the port's
bfloat16 within the configuration's limits, and the control (the
reference one precision step lower) far outside the program's reading."""
import pytest
import torch

import check
import loadgen
import system
from conftest import CELLS, CONFIGS, DENSE, smoke_config

LENGTHS = (40, 64, 23)


def served_and_reference(cfg, seed=5):
    traffic = {"ladder": {"lengths": [64], "batches": [4]},
               "queue_depth": 8}
    arch = CELLS.arch(cfg)
    server = arch.system.build(cfg, arch.weights.make(cfg, seed, "cpu"),
                               traffic)
    prompts = [torch.from_numpy(loadgen.request_tokens(
        seed, i, n, cfg["vocab_size"])) for i, n in enumerate(LENGTHS)]
    mat = torch.zeros(4, 64, dtype=torch.int64)
    for i, p in enumerate(prompts):
        mat[i, :len(p)] = p
    out = server.program(4, 64)(mat)
    served = [out[i, :len(p)].clone() for i, p in enumerate(prompts)]
    system.release(server)
    return served, prompts


def worst(a, b):
    w = check.Worst()
    for x, y in zip(a, b):
        w.add(x, y)
    return w.value


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_port_at_float32(name):
    cfg = dict(smoke_config(name), compute_dtype="float32")
    served, prompts = served_and_reference(cfg)
    arch = CELLS.arch(cfg)
    ref = arch.reference.score(arch.weights.make(cfg, 5, "cpu"), cfg,
                               prompts)
    got = worst(served, ref)
    assert got["logit_err"] < 1e-5 and got["top1_gap"] == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_port_within_limits_control_far_outside(name):
    cfg = smoke_config(name)
    served, prompts = served_and_reference(cfg)
    arch = CELLS.arch(cfg)
    w = arch.weights.make(cfg, 5, "cpu")
    ref = arch.reference.score(w, cfg, prompts)
    ctl = arch.reference.score(w, cfg, prompts, control=True)
    prog, low = worst(served, ref), worst(ctl, ref)
    ok, _ = check.verdict(check_of(prog), cfg["limits"], 0)
    assert ok
    assert low["logit_err"] > 3 * prog["logit_err"]


def check_of(value):
    w = check.Worst()
    w.value = dict(value)
    return w


def test_prune_keeps_the_largest_of_each_row_of_the_transpose():
    w = torch.tensor([[1.0, -5.0], [-3.0, 0.5], [2.0, 4.0]])   # (3, 2)
    got = DENSE.reference.prune(w, 1 / 3)        # keep 1 of 3 inputs an output
    assert got.tolist() == [[0.0, -5.0], [-3.0, 0.0], [0.0, 0.0]]


def test_unanswered_request_fails_the_verdict():
    w = check.Worst()
    ok, compared = check.verdict(w, {"logit_err": 1, "top1_gap": 1}, 1)
    assert not ok and compared["unanswered"]["value"] == 1
