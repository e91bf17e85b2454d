"""The plain reference against the port on the CPU at smoke widths: the
loss, a job of one and of two rounds, and the race and ledger."""
import numpy as np
import pytest
import torch

from fl_bench import check, harness
from fl_bench.reference import chain as ref_chain
from fl_bench.reference import fedavg as ref_fedavg
from fl_bench.reference import transformer as ref_model
from fl_bench.tests.conftest import smoke_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5


def test_loss_is_the_port_loss():
    from repro_torch import tree
    from repro_torch.models import transformer

    cell = smoke_cell()
    w = harness.make_weights(SEED, cell, CPU)
    tokens = harness.make_batch(SEED, 0, cell, 1, CPU)[0, 0]
    cfg = harness.program_config(cell)
    params = tree.unflatten(harness.port_weights(cell, w))
    want, _ = transformer.train_loss(params, cfg, {"tokens": tokens},
                                     remat=False)
    got = ref_model.loss(w, cell.config, tokens)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("rounds,eval_every", [(1, 1), (2, 1), (3, 2)])
def test_job_against_the_port(rounds, eval_every):
    cell = smoke_cell(rounds=rounds, eval_every=eval_every)
    program = harness.Program(cell, CPU)
    w = harness.make_weights(SEED, cell, CPU)
    tokens = harness.make_batch(SEED, 0, cell, rounds, CPU)
    result = program.job(harness.port_weights(cell, w), tokens, 7)
    # the loop driver runs every round outside a graph
    assert sorted(result.digest_sums) == list(range(rounds))
    values = check.check_job(cell, program, w, SEED, 0, result, CPU)
    assert values["mine_mismatch"] == 0
    for name in ("loss_gap", "update_gap", "divergence_gap", "digest_gap"):
        assert values[name] < 1e-5, (name, values)
    correct, _ = check.judge(values, cell.limits)
    assert correct


def test_weights_and_batches_follow_the_seed():
    cell = smoke_cell()
    a = harness.make_weights(SEED, cell, CPU)
    b = harness.make_weights(SEED, cell, CPU)
    c = harness.make_weights(SEED + 1, cell, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["attn_norm"], torch.ones_like(a["attn_norm"]))
    t = cell.traffic
    x = harness.make_batch(SEED, 3, cell, 2, CPU)
    assert x.shape == (2, cell.clients, t["sequences"], t["seq"] + 1)
    assert torch.equal(x, harness.make_batch(SEED, 3, cell, 2, CPU))
    assert not torch.equal(x, harness.make_batch(SEED, 4, cell, 2, CPU))
    assert 0 <= int(x.min()) and int(x.max()) < 512


@pytest.mark.parametrize("clients,attempts,round_idx",
                         [(1, 64, 0), (4, 1000, 3), (7, 257, 4095)])
def test_race_is_the_port_race(clients, attempts, round_idx):
    from repro_torch.core import mining
    from repro_torch.kernels.pow_hash import ops

    rng = np.random.default_rng(clients)
    for _ in range(3):
        prev, digest = (int(x) for x in rng.integers(0, 2 ** 32, 2))
        metrics, new = ops.mine_seal(
            mining.as_word(prev), mining.as_word(digest), clients, attempts,
            nonce_offset=torch.tensor((round_idx << 20) & 0xFFFFFFFF),
            difficulty_bits=4)
        winner, nonce, pow_hash = ref_chain.race(prev, digest, clients,
                                                 attempts, round_idx)
        assert (int(metrics["winner"]), int(metrics["nonce"]),
                int(metrics["pow_hash"])) == (winner, nonce, pow_hash)
        assert int(new) == int(ref_chain.mix_hash(prev, digest, nonce))
    assert ref_chain.GENESIS == __import__(
        "repro_torch.core.chain", fromlist=["x"]).GENESIS_HASH


def test_chain_check_finds_a_tampered_round():
    cell = smoke_cell(rounds=3)
    program = harness.Program(cell, CPU)
    w = harness.make_weights(SEED, cell, CPU)
    tokens = harness.make_batch(SEED, 0, cell, 3, CPU)
    result = program.job(harness.port_weights(cell, w), tokens, 7)
    attempts = cell.traffic["spec"]["mine_attempts"]
    assert ref_chain.check_job(result.history, result.blocks, cell.clients,
                               attempts) == 0
    history = [dict(h) for h in result.history]
    history[1]["nonce"] += 1
    assert ref_chain.check_job(history, result.blocks, cell.clients,
                               attempts) >= 1
    blocks = list(result.blocks)
    blocks[2] = blocks[2].__class__(**{**blocks[2].__dict__, "winner": 1 -
                                       blocks[2].winner})
    assert ref_chain.check_job(result.history, blocks, cell.clients,
                               attempts) == 1


def test_fold_is_the_port_fold():
    from repro_torch.core import mining

    gen = torch.Generator().manual_seed(3)
    tree = {k: torch.randn(2, n, generator=gen)
            for k, n in (("b", 5), ("a", 7), ("c", 1))}
    sums = [float(tree[k].sum()) for k in sorted(tree)]
    assert ref_chain.DIGEST_INIT == mining.DIGEST_INIT
    assert ref_chain.fold_digest(sums) == int(mining.digest_tree(tree))
    assert ref_chain.fold_digest(sums[::-1]) != int(mining.digest_tree(tree))


def test_reference_evaluates_as_the_job_says():
    cell = smoke_cell(rounds=3, eval_every=2)
    spec = cell.traffic["spec"]
    evals = [cell.job.evaluates(spec, k, 3) for k in range(3)]
    assert evals == [False, True, True]
    w = harness.make_weights(SEED, cell, CPU)
    tokens = harness.make_batch(SEED, 0, cell, 3, CPU)
    out, _ = ref_fedavg.run_job(w, cell.config, tokens, 2, 0.01,
                                ref_model.loss, evals)
    assert [np.isnan(x) for x in out["global_loss"]] == [True, False, False]
    for sums in out["digest"]:
        assert set(sums) == set(w)
        assert all(m >= abs(s) > 0 for s, m in sums.values())


def test_digest_sums_keep_the_kernel_launch_count():
    """The card's path counts a launch as ``digest_div_flat.launches += 1``
    by its module name; while the harness keeps the sums, that count
    still lands on the wrapper ``kernels.launch_counts()`` reads."""
    from repro_torch import kernels
    from repro_torch.kernels.fedavg import ops

    program = harness.Program(smoke_cell(), CPU)
    before = kernels.launch_counts()["digest_div_flat"]
    sums = []
    with program.digest_sums(sums):
        ops.digest_div_flat.launches += 1
        total, _ = ops.digest_div_flat(torch.ones(2, 5))
    assert kernels.launch_counts()["digest_div_flat"] == before + 1
    ops.digest_div_flat.launches -= 1
    assert [float(s) for s in sums] == [float(total)] == [10.0]
    assert ops.digest_div_flat is kernels.WRAPPERS["digest_div_flat"]
