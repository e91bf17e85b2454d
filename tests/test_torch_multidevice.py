"""The port's client-sharded engine over gloo ranks on the CPU.

One process a rank (``launch.mesh.run_world``), the client axis split in
rank order. The gather tier reproduces the port's one-process run bit for
bit (params, every metric, the ledger) on the JAX package's eleven
topology cases of ``tests/test_multidevice_scan.py`` at C = 8, K = 3 over
4 ranks, on stacked batches, on ``ClusterTopology`` laid out as 2 pods of
2, on the cohort driver (8 of 64 over 2 ranks) and on a phi4-mini smoke
``--arch`` run over 2 ranks. The psum tier holds to rtol 1e-5 with a
valid chain. Three paths hold to the JAX package's single-device
loop at ``torch_runs``' tolerance. Each world is spawned once per module
(a fixture) and every parametrized case reads its result.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist
import torch_runs
from repro.core import topology as jtopology
from repro_torch.benchmarks import bench_hierarchy, bench_multidevice
from repro_torch.core import rounds, topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

C, K, D = 8, 3, 4
PSUM_RTOL = 1e-5

# the JAX package's eleven cases (tests/test_multidevice_scan.py:35-60)
CASES = {
    "full_mesh": (topology.FullMesh(),
                  dict(n_lazy=1, sigma2=0.05, dp_sigma=0.05)),
    "full_mesh_detect": (topology.FullMesh(),
                         dict(detect_lazy=True, n_lazy=2, sigma2=0.01)),
    "ring1_halo": (topology.Ring(neighbors=1), dict(n_lazy=1, sigma2=0.05)),
    "ring2_halo_edge": (topology.Ring(neighbors=2), {}),
    "random_graph_stride": (topology.RandomGraph(p_link=0.6),
                            dict(eval_every=2)),
    "partial": (topology.PartialParticipation(n_active=3), {}),
    "rotate_schedule": (topology.GossipRotation(),
                        dict(n_lazy=1, sigma2=0.05)),
    "alt_schedule": (topology.AlternatingSchedule(
        ((topology.Ring(neighbors=1), 2), (topology.FullMesh(), 1))), {}),
    "alt_schedule_random": (topology.AlternatingSchedule(
        ((topology.RandomGraph(p_link=0.6), 1), (topology.FullMesh(), 1))),
        {}),
    "snr_weighted": (topology.LinkQualitySchedule(fading_period=3),
                     dict(data_weights=tuple(float(i + 1)
                                             for i in range(C)))),
    "pair_shift_cross_block": (topology.PairShift(shift=5), {}),
}
# the psum tier (fast_allreduce), held to the gather tier's one-process
# run: FullMesh's EXEC_PSUM, a dense W's EXEC_PSUM_DENSE plain and on the
# mix_rows_flat kernel's plain twin
PSUM_CASES = {
    "psum_full_mesh": (topology.FullMesh(), dict(n_lazy=1, sigma2=0.05)),
    "psum_dense_random": (topology.RandomGraph(p_link=0.5), {}),
    "psum_dense_random_fused": (topology.RandomGraph(p_link=0.5),
                                dict(fused_mix=True)),
}
# C = 16 so that each of the 4 ranks holds >= 2 clients of a cluster
CLUSTER_C = 16
CLUSTER_CASES = {
    "cluster_aligned": (topology.ClusterTopology(n_clusters=2), {}),
    # the lazy copy gathers the set first: the pods' rows come from it
    "cluster_aligned_lazy": (topology.ClusterTopology(n_clusters=2),
                             dict(n_lazy=1, sigma2=0.02)),
    "cluster_unaligned": (topology.ClusterTopology(n_clusters=4,
                                                   inter_weight=0.5), {}),
}
# paths held to the JAX package's single-device loop (torch_runs.run_pair)
REFERENCE_PATHS = {
    "full": (jtopology.FullMesh(), topology.FullMesh(), False),
    "ring": (jtopology.Ring(neighbors=1), topology.Ring(neighbors=1), False),
    "random": (jtopology.RandomGraph(p_link=0.5),
               topology.RandomGraph(p_link=0.5), True),
}
REF_C = 4


def _spec(c, topo, **extra):
    return rounds.RoundSpec(n_clients=c, tau=2, eta=0.1, mine_attempts=64,
                            difficulty_bits=2, topology=topo, **extra)


def _stacked_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 1, (K, C, torch_dist.M, 784))
            .astype(np.float32),
            "y": rng.integers(0, 10, (K, C, torch_dist.M))
            .astype(np.int64)}


def _reference_inputs():
    """torch_runs' reference inputs at C = REF_C and the JAX package's
    run (its per-round loop) of each REFERENCE_PATHS entry."""
    params, batch = torch_runs.inputs(REF_C)
    out = {}
    for name, (jtopo, topo, inject) in REFERENCE_PATHS.items():
        jspec, spec = torch_runs.specs(REF_C, {"topology": jtopo},
                                       {"topology": topo})
        key = jax.random.key(1)
        mats = (torch_runs.reference_matrices(jtopo, REF_C, key, K)
                if inject else None)
        ref, _ = torch_runs.run_pair(jspec, spec, inject_matrices=inject)
        out[name] = (spec, mats, ref)
    return params, batch, out


def _jobs(ref_params, ref_batch, ref_paths):
    params, batch = torch_dist.mlp_inputs(C)
    cparams, cbatch = torch_dist.mlp_inputs(CLUSTER_C, seed=7)
    flat = ("data", D)
    jobs = [(name, flat, _spec(C, topo, **extra), params, batch, K, {})
            for name, (topo, extra) in {**CASES, **PSUM_CASES}.items()]
    jobs.append(("stacked", flat, _spec(C, topology.Ring(neighbors=1),
                                        n_lazy=1, sigma2=0.02),
                 params, _stacked_batch(), K, {"stacked": True}))
    for name, (topo, extra) in CLUSTER_CASES.items():
        jobs.append((name, ("cluster", 2), _spec(CLUSTER_C, topo, **extra),
                     cparams, cbatch, K, {}))
    # the reference paths over 4 ranks at C = REF_C (one client a rank)
    for name, (spec, mats, _) in ref_paths.items():
        jobs.append((f"reference_{name}", flat, spec,
                     ref_params, ref_batch, K,
                     {"topology_matrices": mats, "seed": 0}))
    return jobs


@pytest.fixture(scope="module")
def world():
    """Every job on one 4-rank gloo world, and each job's one-process run
    in the gather tier (the jobs' own inputs, no mesh; a psum job's spec
    without fast_allreduce)."""
    ref_params, ref_batch, ref_paths = _reference_inputs()
    jobs = _jobs(ref_params, ref_batch, ref_paths)
    ranks = mesh_lib.run_world(torch_dist.runs_rank, D, backend="gloo",
                               device="cpu", args=(jobs,))
    single = {name: torch_dist.run_mlp(
        dataclasses.replace(spec, fast_allreduce=False), p, b, k, **kw)
        for name, _, spec, p, b, k, kw in jobs}
    return ranks, single, ref_paths


def _nan_equal(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _assert_bitwise(got, want, name):
    (p, hist, hashes, valid), (wp, whist, whashes, _) = got, want
    for leaf in wp:
        np.testing.assert_array_equal(p[leaf], wp[leaf],
                                      err_msg=f"{name} {leaf}")
    assert [list(h) for h in hist] == [list(h) for h in whist], name
    assert all(_nan_equal(h[key], w[key]) for h, w in zip(hist, whist)
               for key in h), (name, hist, whist)
    assert hashes == whashes and valid and len(hashes) == K, name


@pytest.mark.parametrize("name", sorted(CASES) + ["stacked"]
                         + sorted(CLUSTER_CASES))
def test_gather_tier_is_bitwise_the_one_process_run(world, name):
    ranks, single, _ = world
    for rank in ranks:   # every rank returns the same gathered run
        _assert_bitwise(rank[name], single[name], name)


@pytest.mark.parametrize("name", sorted(PSUM_CASES))
def test_psum_tier_holds_to_tolerance_with_a_valid_chain(world, name):
    """The summed digest is associated differently from the gather tier's
    sweep, so its chain may fork from it (on the CPU torch's sum can split
    at the blocks' edges and give the same bits): held is a valid chain,
    the same on every rank."""
    ranks, single, _ = world
    (p, hist, hashes, valid), (wp, whist, whashes, _) = ranks[0][name], \
        single[name]
    for leaf in wp:
        np.testing.assert_allclose(p[leaf], wp[leaf], rtol=PSUM_RTOL,
                                   atol=PSUM_RTOL, err_msg=leaf)
    for h, w in zip(hist, whist):
        for key in ("local_loss_mean", "global_loss", "divergence"):
            np.testing.assert_allclose(h[key], w[key], rtol=PSUM_RTOL,
                                       err_msg=key)
    assert valid and len(hashes) == K
    for rank in ranks[1:]:     # one chain on every rank
        assert rank[name][2] == hashes


@pytest.mark.parametrize("name", sorted(REFERENCE_PATHS))
def test_sharded_run_holds_to_the_reference_loop(world, name):
    ranks, _, ref_paths = world
    spec, _, ref = ref_paths[name]
    p, hist, hashes, valid = ranks[0][f"reference_{name}"]
    state = rounds.RoundState(
        params={k: torch.from_numpy(v) for k, v in p.items()},
        generator=None, round_idx=K, prev_hash=None)

    class _Ledger:
        blocks = hashes

        @staticmethod
        def validate_chain():
            return valid

    torch_runs.assert_runs_close(ref, (state, hist, _Ledger))


def test_cohort_driver_sharded_is_bitwise_the_one_process_driver():
    spec = _spec(8, topology.Ring(neighbors=1), n_lazy=1, sigma2=0.02)
    params, _ = torch_dist.mlp_inputs(8)
    enrolled, seed, samples = 64, 5, 8
    got = mesh_lib.run_world(torch_dist.cohort_rank, 2, backend="gloo",
                             device="cpu",
                             args=(spec, params, enrolled, K, seed,
                                   samples))
    from repro_torch.data.pipeline import CohortDataSource

    src = CohortDataSource(seed, samples, device="cpu")
    cohort = topology.CohortSchedule(enrolled, 8)
    store, hist, ledger = rounds.run_blade_fl_cohort(
        torch_dist.mlp_client_losses, spec,
        {k: torch.from_numpy(v) for k, v in params.items()},
        src.cohort_batch, K, cohort, seed=seed, device="cpu")
    last = store.gather(hist[-1]["cohort"])
    for rank_hist, hashes, valid, rows, touched in got:
        assert [list(h) for h in rank_hist] == [list(h) for h in hist]
        assert all(_nan_equal(a[k], b[k]) for a, b in zip(rank_hist, hist)
                   for k in a if k != "cohort")
        assert [a["cohort"] for a in rank_hist] == \
            [b["cohort"] for b in hist]
        assert hashes == [b.header_hash for b in ledger.blocks] and valid
        assert touched == store.touched   # every rank's replica
        for k, v in last.items():
            np.testing.assert_array_equal(rows[k], v.numpy(), err_msg=k)


ARCH_ARGS = ["--arch", "phi4-mini-3.8b", "--size", "smoke", "--clients",
             "2", "--per-client", "2", "--seq", "16", "--rounds", "2",
             "--lazy", "1", "--sigma2", "1e-4", "--device", "cpu"]


def test_arch_run_over_two_ranks_is_bitwise_one_process():
    one, ostate, ohist = train.train_arch(
        train.build_parser().parse_args(ARCH_ARGS))
    two, state, hist = train.train_arch(
        train.build_parser().parse_args(ARCH_ARGS + ["--devices", "2"]))
    assert two["devices"] == 2 and two["fast_allreduce"] is False
    assert two["loss_curve"] == one["loss_curve"]
    assert [list(h.items()) for h in hist] == [list(h.items()) for h in ohist]
    for k, v in ostate.params.items():
        assert torch.equal(state.params[k], v), k
    assert two["chain_valid"] and len(two["by_rank"]) == 2


def test_trainer_devices_keys_and_bitwise_one_process(capsys):
    args = ["--arch", "mlp", "--k", "2", "--clients", "4", "--t-sum", "24",
            "--lazy", "1", "--sigma2", "0.01", "--device", "cpu"]
    one = train.run_mlp(train.build_parser().parse_args(args))
    capsys.readouterr()
    two = train.run_mlp(train.build_parser().parse_args(
        args + ["--devices", "2"]))
    printed = json.loads(capsys.readouterr().out)
    assert printed == two
    assert set(two) == set(one) | {"mesh", "by_rank"}
    assert two["devices"] == 2 and two["fast_allreduce"] is False
    assert two["mesh"]["backend"] == "gloo" and two["mesh"]["shape"] == [2]
    assert two["dispatch"]["reason"] == "CPU run: CUDA graphs need the card"
    assert two["final_global_loss"] == one["final_global_loss"]
    assert two["final_eval_loss"] == one["final_eval_loss"]
    assert [r["rank"] for r in two["by_rank"]] == [0, 1]
    # the broadcast set's gather: the other rank's 2 models a round
    model = 4 * (784 * 256 + 256 + 256 * 10 + 10)
    assert two["by_rank"][0]["received_bytes_per_round"]["all_gather"] \
        >= 2 * model


def test_trainer_refuses_nccl_for_two_ranks_without_two_cards():
    with pytest.raises(ValueError, match="--backend gloo"):
        mesh_lib.check_backend("nccl", 2, "cuda")
    with pytest.raises(ValueError, match="runs on cuda"):
        train.main(["--arch", "mlp", "--devices", "2", "--backend", "nccl",
                    "--device", "cpu"])


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="ranks failed"):
        mesh_lib.run_world(torch_dist.mesh_of, 2, backend="gloo",
                           device="cpu", args=(("cluster", 3),))


def test_bench_multidevice_at_a_tiny_size():
    out = bench_multidevice.bench(device_counts=(1, 2), n_rounds=2,
                                  n_clients=4, samples=8, tau=1, reps=1,
                                  device="cpu")
    for d in (1, 2):
        for mode in ("gather", "psum", "kernel"):
            row = out[d][mode]
            assert row["chain_valid"] and row["rounds_per_s"] > 0, (d, mode)
    assert out[1]["gather"]["est_mix_bytes_per_round"] == 0
    assert out[2]["gather_vs_psum_bytes_ratio"] > 1


def test_bench_hierarchy_at_a_tiny_size():
    out = bench_hierarchy.bench(n_clusters=2, n_dev=4, n_rounds=2,
                                n_clients=8, samples=8, tau=1, reps=1,
                                device="cpu")
    assert out["cluster"]["mix_mode"] == "exec_cluster"
    assert out["flat_vs_cluster_bytes_ratio"] > 1
    assert out["flat"]["chain_valid"] and out["cluster"]["chain_valid"]
    assert out["same_ledger"]   # the two layouts, bitwise
