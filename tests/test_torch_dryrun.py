"""The dry-run on meta tensors (``launch/dryrun.py``) on the CPU.

- Every arch x smoke shape (the reference's skips aside) builds and runs
  on one rank of a (data 2, model 2) ``DryMesh``: the train step under
  the arch's layout of the reference's table (L1 or L2, C = 2), in fp32;
  prefill and decode in bf16. A prefill launches flash once an attention
  layer, a round races once and runs fedavg and the sweep once a leaf,
  and every output is a meta tensor.
- The bytes a ``DryMesh`` rank counts are those a rank receives:
  ``serve.serve_on_mesh`` of phi4-mini smoke at (2, 2) under phase 9's
  two plans (rows over data and positions over model; the long-context
  plan) equals ``chip_smoke.serve_received``, and so do phi4-mini's
  ``prefill_32k`` and ``decode_32k`` steps at its published widths on
  the production (16, 16) mesh; one L1 (phi4-mini) and one L2 (qwen3)
  smoke train step equal ``chip_smoke.l1_received`` / ``l2_received``
  by op and axes.
- ``run_pair``'s record has the reference's keys (and the port's), a
  skipped pair the reference's reason; the CLI writes only under
  ``--out-dir`` and exits 1 when a pair failed.
"""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, SMOKE_SHAPES,  # noqa: E402
                                 ShapeConfig, arch_ids, get_arch,
                                 get_smoke_arch)
from repro_torch.launch import dryrun, serve, steps  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.sharding import plans  # noqa: E402
from repro_torch.sharding.specs import ShardingPlan  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
PHI4 = "phi4-mini-3.8b"
CASES = [(a, s) for a in arch_ids() for s in SMOKE_SHAPES
         if not (SMOKE_SHAPES[s].kind == "decode"
                 and not get_smoke_arch(a).has_decode)]


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (its analytic byte counts
    hold the card's ranks)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _train_plan(arch, c=2):
    """The arch's layout of the reference's table at C = ``c`` on a
    (2, 2) mesh."""
    layout = plans._TRAIN_TABLE[get_arch(arch).name][0]
    if layout == "L1":
        return ShardingPlan(c, ("data",), ())
    return ShardingPlan(c, (), ("data",), fsdp_axes=("data",))


def _metas(tree_):
    return all(x.device.type == "meta"
               for x in tree.flatten(tree_).values()
               if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch,shape_name", CASES)
def test_every_smoke_step_traces_on_a_meta_mesh(arch, shape_name):
    cfg, shape = get_smoke_arch(arch), SMOKE_SHAPES[shape_name]
    kind = shape.kind
    mesh = dryrun.DryMesh.make((2, 2), AXES)
    traced = dryrun.trace(kind, cfg, shape, mesh,
                          dtype=dryrun.STEP_DTYPES[kind],
                          plan=_train_plan(arch) if kind == "train" else None)
    costs = traced.costs
    assert costs.flops > 0 and costs.hbm_bytes > 0
    assert costs.collective_bytes == sum(mesh.received.values()) > 0
    n_attn = cfg.layer_kinds().count("attn")
    calls = {k: v["calls"] for k, v in costs.kernels.items()}
    if kind == "prefill":
        logits, state = traced.out
        assert _metas(state) and logits.device.type == "meta"
        assert calls == ({"flash_attention": n_attn} if n_attn else {}) | (
            {"ssm_scan": cfg.layer_kinds().count("ssm")}
            if "ssm" in cfg.layer_kinds() else {})
    elif kind == "decode":
        logits, state = traced.out
        assert _metas(state) and logits.device.type == "meta"
        assert calls == {}   # decode runs no kernel
    else:
        state, metrics = traced.out
        assert _metas(state.params) and _metas(metrics)
        n_leaves = len(tree.flatten(registry.params_specs(cfg)))
        assert calls["fedavg_flat"] == calls["digest_div_flat"] == n_leaves
        assert calls.get("pow_race", 0) + calls.get("mine_seal", 0) == 1
        assert (calls.get("flash_attention_bwd", 0) > 0) == (n_attn > 0)
        assert state.round_idx == 1


def _meta_serve(cfg, mesh_shape, batch, prompt, n_steps, cap, plan, dplan):
    """``serve.serve_on_mesh`` on rank 0 of a meta ``DryMesh``: the bytes
    received by op in the prefill and in ``n_steps`` decode steps."""
    mesh = dryrun.DryMesh.make(mesh_shape, AXES)
    params = registry.params_specs(cfg, torch.float32)
    full = registry.prefill_batch_specs(cfg, ShapeConfig(
        "p", prompt, batch, "prefill"), torch.float32)
    tokens = torch.empty((batch, n_steps), dtype=torch.int32, device="meta")
    res = serve.serve_on_mesh(cfg, params, full, tokens, mesh, plan, dplan,
                              cap)
    assert all(x.device.type == "meta" for x in res["logits"])
    return res["received"]


@pytest.mark.parametrize("layout", ["9a", "9b"])
def test_meta_serve_receives_the_analytic_bytes(layout):
    """phi4-mini smoke served at (2, 2) as phase 9 serves it: prefill of 4
    x 30 and 2 decode steps (rows over data, positions over model), or 1 x
    30 under the long-context plan (positions over data and model)."""
    cfg = get_smoke_arch(PHI4)
    if layout == "9a":
        batch, plan = 4, ShardingPlan(1, (), ("data",))
        dplan = ShardingPlan(1, (), ("data",), seq_axes=("model",))
    else:
        batch, plan = 1, ShardingPlan(1, (), ())
        dplan = ShardingPlan(1, (), (), seq_axes=("data", "model"))
    got = _meta_serve(cfg, (2, 2), batch, 30, 2, 32, plan, dplan)
    want = _chip_smoke().serve_received(cfg, (2, 2), batch, 30, 32, plan,
                                        dplan, 2)
    assert want["prefill"] and want["decode"]
    assert got == want


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_production_mesh_receives_the_analytic_bytes(shape_name):
    """phi4-mini at its published widths, rank 0 of (data 16, model 16):
    the step ``run_pair`` traces receives what ``serve_received`` counts
    for the reference's serve plan (fp32, as that count assumes)."""
    cfg, shape = get_arch(PHI4), INPUT_SHAPES[shape_name]
    mesh = dryrun.production_mesh(False)
    traced = dryrun.trace(shape.kind, cfg, shape, mesh, dtype=torch.float32)
    plan = traced.plan
    assert not plan.fsdp_axes and not cfg.sliding_window
    if shape.kind == "prefill":
        want = _chip_smoke().serve_received(
            cfg, (16, 16), shape.global_batch, shape.seq_len, shape.seq_len,
            plan, plan, 0)["prefill"]
    else:
        want = _chip_smoke().serve_received(
            cfg, (16, 16), shape.global_batch, 1, shape.seq_len, plan, plan,
            1)["decode"]
    assert want and mesh.received == want
    assert traced.costs.collective_by_op() == {
        **{op: 0.0 for op in ("all_gather", "all_reduce", "shift",
                              "reduce_scatter")}, **want}


@pytest.mark.parametrize("arch,layout", [(PHI4, "L1"), ("qwen3-32b", "L2")])
def test_meta_train_step_receives_the_analytic_bytes(arch, layout):
    """One smoke round at (2, 2), C = 2 (``round_spec_for``'s: no lazy
    client, no global-loss eval), by op and axes."""
    cfg, shape = get_smoke_arch(arch), SMOKE_SHAPES["smoke_train"]
    plan = _train_plan(arch)
    mesh = dryrun.DryMesh.make((2, 2), AXES)
    traced = dryrun.trace("train", cfg, shape, mesh, dtype=torch.float32,
                          plan=plan)
    rspec = steps.round_spec_for(cfg, shape, plan)
    counts = (_chip_smoke().l1_received if layout == "L1"
              else _chip_smoke().l2_received)
    state = traced.inputs[0]
    want = counts(cfg, rspec, traced.step.in_specs[0].params,
                  {k: tuple(v.shape[1:]) for k, v in state.params.items()},
                  {"data": 2, "model": 2}, shape.global_batch // 2,
                  shape.seq_len)
    assert mesh.received_by_axes == want
    assert traced.costs.collective_by_axes == want


RECORD_KEYS = {"arch", "shape", "mesh", "kind", "status", "rank", "dtype",
               "plan", "trace_s", "memory", "cost", "roofline",
               "model_flops", "useful_flops_ratio", "active_params",
               "total_params"}


def test_run_pair_record_has_the_reference_keys():
    rec = dryrun.run_pair(PHI4, "decode_32k", False)
    assert set(rec) == RECORD_KEYS and rec["status"] == "ok"
    assert rec["mesh"] == "pod16x16" and rec["dtype"] == "bfloat16"
    assert set(rec["plan"]) == {"n_clients", "client_axes", "batch_axes",
                                "fsdp_axes", "seq_axes"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "peak_live_bytes"}
    assert rec["memory"]["peak_live_bytes"] >= rec["memory"][
        "argument_bytes"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s", "chips",
                                    "total_flops", "total_bytes"}
    assert rec["roofline"]["chips"] == 256
    cfg = get_arch(PHI4)
    assert rec["model_flops"] == 2 * cfg.active_param_count() * 128
    assert 0 < rec["useful_flops_ratio"] <= 1.5
    for key in ("flops", "hbm_bytes", "collective_bytes", "all_reduce",
                "all_gather", "n_all_reduce", "attention_masked_flops",
                "bytes_by_op", "kernels"):
        assert key in rec["cost"]
    json.dumps(rec)
    skipped = dryrun.run_pair("hubert-xlarge", "decode_32k", True)
    assert skipped["status"] == "skipped" and skipped["reason"] == \
        jsteps.skip_reason(jconfigs.get_arch("hubert-xlarge"),
                           jconfigs.get_shape("decode_32k"))


def test_cli_writes_only_under_out_dir(tmp_path, monkeypatch):
    experiments = os.path.join(ROOT, "experiments", "dryrun")
    before = (sorted(os.listdir(experiments))
              if os.path.isdir(experiments) else None)
    out = tmp_path / "records"
    rc = dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k",
                      "--both-meshes", "--out-dir", str(out)])
    assert rc == 0
    names = sorted(os.listdir(out))
    assert names == ["hubert-xlarge__long_500k__pod16x16.json",
                     "hubert-xlarge__long_500k__pod2x16x16.json"]
    for name in names:
        assert json.loads((out / name).read_text())["status"] == "skipped"

    def broken(*args):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "run_pair", broken)
    rc = dryrun.main(["--arch", PHI4, "--shape", "decode_32k", "--out-dir",
                      str(out)])
    assert rc == 1
    rec = json.loads((out / f"{PHI4}__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "failed" and "planted" in rec["error"]
    assert (sorted(os.listdir(experiments))
            if os.path.isdir(experiments) else None) == before
    assert dryrun.OUT_DIR == os.path.join(ROOT, "build", "dryrun")


@pytest.mark.parametrize("grad", [False, True, "checkpoint"])
def test_meta_slstm_counts_its_steps(grad):
    """On meta tensors the sLSTM's T steps run as one step counted T times
    (``xlstm._SLSTMSteps`` under grad): the forward's counts equal the
    op-by-op loop's on the CPU exactly; with its backward, the flops
    within 1 % and the bytes within 5 % (the first step's backward and
    the engine's sums of the steps' gradients, modelled) at T = 40, also
    under a non-reentrant checkpoint (the microbatched train step's: its
    recompute counted once, not inside the backward's T trips)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch import cost_analysis
    from repro_torch.models import xlstm

    cfg = get_smoke_arch("xlstm-125m")
    flat = tree.flatten(xlstm.init_slstm(torch.Generator().manual_seed(0),
                                         cfg))
    costs, outs = {}, {}
    for dev in ("cpu", "meta"):
        leaves = {k: v.to(dev).requires_grad_(bool(grad))
                  for k, v in flat.items()}
        x = torch.randn((2, 40, cfg.d_model)).to(dev).requires_grad_(
            bool(grad))
        def run(leaves, x):
            out, state = xlstm.slstm_forward(tree.unflatten(leaves), cfg, x)
            return [out] + list(state.values())

        with cost_analysis.CostCounter() as counter:
            got = (checkpoint(run, leaves, x, use_reentrant=False)
                   if grad == "checkpoint" else run(leaves, x))
            out = got[0]
            if grad:
                got += torch.autograd.grad(out.sum(), [x, *leaves.values()])
        costs[dev], outs[dev] = counter.costs, got
    for a, b in zip(outs["cpu"], outs["meta"]):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    cpu, meta = costs["cpu"], costs["meta"]
    if not grad:
        assert (meta.flops, meta.hbm_bytes, meta.count_by_op) == \
            (cpu.flops, cpu.hbm_bytes, cpu.count_by_op)
    else:
        assert meta.flops == pytest.approx(cpu.flops, rel=1e-2)
        assert meta.hbm_bytes == pytest.approx(cpu.hbm_bytes, rel=5e-2)


def test_mla_decode_past_a_window_is_a_ring():
    """deepseek-v2 × long_500k runs the sliding-window variant (a latent
    cache of ``window`` slots): MLA's decode keeps it as a ring, as GQA's
    does. deepseek smoke with a window of 8 (capacity out of the way):
    prefill of 12 tokens and 6 decode steps, each past the 8 slots,
    against one windowed forward over the 18, at rtol 1e-4 / atol 1e-5."""
    import dataclasses

    from repro_torch.models import transformer

    base = get_smoke_arch("deepseek-v2-236b")
    cfg = dataclasses.replace(base, sliding_window=8, moe=dataclasses.replace(
        base.moe, capacity_factor=8.0))
    params = registry.init_model(torch.Generator().manual_seed(3), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 18),
                         generator=torch.Generator().manual_seed(4))
    h, _, _ = transformer.forward(
        params, cfg, transformer._embed_inputs(params, cfg,
                                               {"tokens": toks})[0])
    want = transformer._lm_head(params, cfg, h[:, 11:])
    logits, state = transformer.prefill(params, cfg, {"tokens": toks[:, :12]},
                                        max_len=18)
    assert state["prefix"][0]["ckv"].shape[1] == 8
    got = [logits]
    for t in range(12, 18):
        logits, state = transformer.decode_step(params, cfg, state,
                                                toks[:, t], t)
        got.append(logits)
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4,
                               atol=1e-5)
