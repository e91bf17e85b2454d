"""Each operation and byte count against a hand count, and mfu's matrix
products against the port's 6 N D (``launch/analysis.model_flops``)."""
import math

import pytest

from fl_bench import counts, families, harness, jobs, peaks
from fl_bench.reference import transformer as ref_model
from fl_bench.tests.conftest import CELLS

TINY = {"family": "transformer", "n_layers": 1, "d_model": 4, "n_heads": 2,
        "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab": 10}
TINY_TRAFFIC = {"job": "fedavg", "spec": {"n_clients": 3, "tau": 2},
                "sequences": 1, "seq": 3}
FAMILY = families.load("transformer")


def test_tiny_by_hand():
    # wq 4x4, wk and wv 4x2 each, wo 4x4, three MLP matrices 4x8, head 10x4
    assert FAMILY.matmul_weights(TINY) == 16 + 8 + 8 + 16 + 96 + 40
    assert counts.causal_pairs(3) == 6
    # 2 a weight a token over 3 tokens, 4 D a pair a head (2 heads, D 2)
    assert FAMILY.forward_flops(TINY, 1, 3) == 2 * 184 * 3 + 4 * 2 * 2 * 6
    # 3 clients x (3 tau + 1) forwards
    assert counts.round_flops(TINY, TINY_TRAFFIC) == 3 * 7 * 1200
    assert counts.round_tokens(TINY_TRAFFIC) == 3 * 1 * 3 * 2
    # q and o [1, 3, 2, 2], k and v [1, 3, 1, 2], lse [1, 2, 3], fp32
    q, kv, lse = 12 * 4, 6 * 4, 6 * 4
    assert counts.flash_call(TINY, TINY_TRAFFIC, False) == (
        4 * 2 * 2 * 6, 2 * q + 2 * kv + lse)
    assert counts.flash_call(TINY, TINY_TRAFFIC, False, lse=False) == (
        4 * 2 * 2 * 6, 2 * q + 2 * kv)
    assert counts.flash_call(TINY, TINY_TRAFFIC, True) == (
        8 * 2 * 2 * 6, 4 * q + 4 * kv + lse)
    n = sum(counts.leaf_sizes(TINY))
    assert n == 40 + 4 + 4 + 16 + 8 + 8 + 16 + 4 + 32 + 32 + 32
    assert counts.fedavg_bytes(TINY, 3) == 4 * (2 * 3 * n + 3 * 11)
    assert counts.digest_bytes(TINY, 3) == 4 * (3 * n + 4 * 11)


@pytest.mark.parametrize("every,want_evals", [(1, 8), (2, 4), (3, 3),
                                              (8, 1)])
def test_launches_by_hand(every, want_evals):
    """A job of 8 rounds: a race, a FedAvg and a digest sweep of each of
    11 leaves a round; 3 clients' 2 forwards and backwards a round and a
    forward each on the evaluating rounds (every ``every``-th and the
    last), through 1 attention layer."""
    spec = {"n_clients": 3, "tau": 2, "eval_every": every}
    assert sum(jobs.load("fedavg").evaluates(spec, k, 8)
               for k in range(8)) == want_evals
    assert jobs.load("fedavg").launches(spec, FAMILY, TINY, 8, 11) == {
        "pow_race": 8, "fedavg_flat": 88, "digest_div_flat": 88,
        "flash_attention": 3 * (2 * 8 + want_evals),
        "flash_attention_bwd": 3 * 2 * 8}


@pytest.mark.parametrize("cell", CELLS)
def test_leaves_match_the_port(cell):
    c = harness.load_cell(cell)
    cfg = harness.program_config(c)
    sizes = counts.leaf_sizes(c.config)
    assert sizes == [math.prod(s) for s in
                     ref_model.leaf_shapes(c.config).values()]
    assert sum(sizes) == cfg.param_count()
    # every parameter but the norm scales enters a product once a token
    d, layers = c.config["d_model"], c.config["n_layers"]
    assert FAMILY.matmul_weights(c.config) == cfg.param_count() - d \
        - 2 * layers * d


@pytest.mark.parametrize("cell", CELLS)
def test_mfu_products_are_6nd(cell):
    from repro_torch.launch import analysis

    c = harness.load_cell(cell)
    w, t = c.config, c.traffic
    tau = t["spec"]["tau"]
    n = FAMILY.matmul_weights(w)
    tokens = c.clients * t["sequences"] * t["seq"]
    attn = (FAMILY.forward_flops(w, t["sequences"], t["seq"])
            - 2.0 * n * t["sequences"] * t["seq"])
    matmul = (counts.round_flops(w, t)
              - c.clients * (3 * tau + 1) * attn
              - 2.0 * n * tokens)            # the global loss's forward
    assert matmul == pytest.approx(analysis.model_flops(
        n, tokens, backward=True, local_iters=tau), rel=1e-12)
    assert peaks.FLOPS == 494.7e12 and peaks.HBM_BYTES == analysis.HBM_BW


def test_phi4_round_is_41_tflop():
    """2 clients x (3 tau + 1) forwards of 2 x 512 tokens through 1.420 G
    matmul weights (8 layers of 0.1007 G and the 0.615 G head), and the
    attention's 4 D a kept pair a head: 41.1 TFLOP."""
    c = harness.load_cell(CELLS[0])
    assert FAMILY.matmul_weights(c.config) == 200064 * 3072 + 8 * (
        2 * 3072 * 3072 + 2 * 3072 * 1024 + 3 * 3072 * 8192)
    assert counts.round_flops(c.config, c.traffic) == pytest.approx(
        41.07e12, rel=0.002)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(494.7e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
