"""The port's roofline terms and cost counter (``launch/analysis.py``,
``launch/cost_analysis.py``) against the JAX package's ``launch/analysis``
and ``launch/hlo_analysis``, and the kernels' meta branches.

- ``roofline`` and ``model_flops`` on the same inputs: the same keys,
  each term the reference's scaled by the ratio of the two devices'
  constants (the port's are the H100's).
- The counter and ``hlo_analysis.analyze_dict`` on the reference test's
  seven chained 64 x 64 matmuls: the same flops.
- The smoke prefill of phi4-mini, minicpm and nemotron on one rank: the
  port's ``flops + attention_masked_flops`` (the pairs flash skips, which
  the reference's einsum attention computes) against the reference's
  loop-aware count of its compiled ``build_prefill_step`` on one CPU
  device, equal to rtol 1e-12 (both count 2 M N K a product, exactly).
- Each kernel entry point on meta tensors: its outputs' shapes and
  dtypes those of the CPU call, the cost it reports the kernel table's
  formula (written out again here), and the plain twin never run
  (patched to raise). On the CPU the twin's own ops are hidden from the
  counter and the same cost is reported.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import get_shape, get_smoke_arch  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.pow_hash import ops as pow_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch import analysis, cost_analysis, dryrun  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402 (fixture)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# roofline and model flops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("costs", [(197e12, 819e9, 50e9, 256),
                                   (3.1e15, 2.0e9, 7.5e11, 512),
                                   (0.0, 1.0, 0.0, 1)])
def test_roofline_is_the_reference_terms_at_h100_constants(costs):
    flops, nbytes, coll, chips = costs
    got = analysis.roofline(flops, nbytes, coll, chips)
    want = janalysis.roofline(flops, nbytes, coll, chips)
    assert set(got) == set(want)
    scale = {"compute_s": (jmesh.PEAK_FLOPS_BF16, analysis.PEAK_FLOPS_BF16),
             "memory_s": (jmesh.HBM_BW, analysis.HBM_BW),
             "collective_s": (jmesh.ICI_BW, analysis.NVLINK_BW)}
    for key, (theirs, ours) in scale.items():
        assert got[key] == pytest.approx(want[key] * theirs / ours,
                                         rel=1e-12)
    terms = {k: got[k] for k in scale}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["bound_s"] == terms[got["dominant"]]
    for key in ("chips", "total_flops", "total_bytes"):
        assert got[key] == want[key]
    fp32 = analysis.roofline(flops, nbytes, coll, chips,
                             peak_flops=analysis.PEAK_FLOPS_FP32)
    assert fp32["compute_s"] == pytest.approx(flops / 66.9e12, rel=1e-12)
    assert (analysis.PEAK_FLOPS_BF16, analysis.PEAK_FLOPS_FP32,
            analysis.HBM_BW, analysis.NVLINK_BW) == (989.4e12, 66.9e12,
                                                     3.35e12, 450e9)


@pytest.mark.parametrize("args", [(10, 100, True), (10, 100, False),
                                  (3_021_835_264, 2 * 4096, True, 2)])
def test_model_flops_is_the_reference(args):
    assert analysis.model_flops(*args) == janalysis.model_flops(*args)


# ---------------------------------------------------------------------------
# the counter against the reference's HLO count
# ---------------------------------------------------------------------------


def test_counter_counts_chained_matmuls_as_the_reference():
    """The reference test's scan of seven 64 x 64 products: 7 x 2 x 64^3
    flops in both counts; the port's bytes are each product's two
    operands read and its output written."""
    def f(x):
        def body(c, _):
            return c @ c, None
        c, _ = jax.lax.scan(body, x, None, length=7)
        return c

    x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    want = hlo_analysis.analyze_dict(jax.jit(f).lower(x).compile().as_text())
    c = torch.empty((64, 64), device=META)
    with cost_analysis.CostCounter() as counter:
        for _ in range(7):
            c = c @ c
    got = counter.costs.as_dict()
    assert got["flops"] == want["flops"] == 7 * 2 * 64 ** 3
    assert got["hbm_bytes"] == 7 * 3 * 64 * 64 * 4
    assert got["count_by_op"] == {"mm": 7}
    for key in ("flops", "hbm_bytes", "collective_bytes", "all_gather",
                "all_reduce", "n_all_gather", "n_all_reduce"):
        assert key in got


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minicpm-2b",
                                  "nemotron-4-15b"])
def test_prefill_flops_match_the_reference_hlo(arch):
    shape = jconfigs.get_shape("smoke_prefill")
    mesh = jmesh.make_host_mesh((1, 1), ("data", "model"))
    with mesh:
        step, abs_in, _ = jsteps.build_prefill_step(
            jconfigs.get_smoke_arch(arch), shape, mesh, False, jnp.float32)
        want = hlo_analysis.analyze_dict(
            step.lower(*abs_in).compile().as_text())
    traced = dryrun.trace("prefill", get_smoke_arch(arch),
                          get_shape("smoke_prefill"),
                          dryrun.DryMesh.make((1, 1), ("data", "model")),
                          dtype=torch.float32)
    costs = traced.costs
    assert costs.attention_masked_flops > 0
    assert costs.flops + costs.attention_masked_flops == pytest.approx(
        want["flops"], rel=1e-12)
    assert costs.collective_bytes == 0


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------


def _raise(*args, **kwargs):
    raise AssertionError("the plain twin ran on meta tensors")


def _meta(*tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device=META)
            for t in tensors]


def _same_layout(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _reported(fn):
    with cost_analysis.CostCounter() as counter:
        out = fn()
    return out, counter.costs


def _kept(s, causal, window, prefix):
    return int(flash_ref.keep_mask(s, causal=causal, window=window,
                                   prefix_len=prefix, device="cpu").sum())


FLASH_CASES = [  # (b, h, hkv, s, d, causal, window, prefix, dtype)
    (2, 4, 4, 37, 32, True, 0, 0, torch.float32),
    (1, 6, 2, 64, 16, True, 9, 0, torch.float32),
    (2, 4, 1, 50, 8, True, 0, 20, torch.bfloat16),
    (1, 2, 2, 33, 12, False, 0, 0, torch.float32),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_meta_branch_reports_its_cost(monkeypatch, case):
    b, h, hkv, s, d, causal, window, prefix, dtype = case
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen).to(dtype)
    mask = dict(causal=causal, window=window, prefix_len=prefix)
    cpu, cpu_costs = _reported(lambda: flash_ops.mha(q, k, v, **mask))
    monkeypatch.setattr(flash_ops, "mha_ref", _raise)
    monkeypatch.setattr(flash_ops, "attention_ref", _raise)
    mq, mk, mv = _meta(q, k, v)
    got, costs = _reported(lambda: flash_ops.mha(mq, mk, mv, **mask))
    _same_layout(got, cpu)
    kept = _kept(s, causal, window, prefix)
    item = q.element_size()
    want = {"calls": 1, "flops": 4 * d * b * h * kept,
            "hbm_bytes": item * (2 * b * s * h * d + 2 * b * s * hkv * d),
            "masked_flops": 4 * d * b * h * (s * s - kept)}
    assert costs.kernels == {"flash_attention": want}
    assert costs.flops == want["flops"]
    # the CPU call: the same cost, none of the twin's ops counted
    assert cpu_costs.kernels == costs.kernels
    assert "bmm" not in cpu_costs.count_by_op
    # the [B, H, S, D] entry point of the TPU kernel's layout
    if h == hkv:
        qt, kt, vt = (x.transpose(1, 2) for x in (mq, mk, mv))
        got, costs = _reported(lambda: flash_ops.flash_attention(
            qt, kt, vt, **mask))
        assert tuple(got.shape) == tuple(qt.shape)
        assert costs.kernels == {"flash_attention": want}


def test_flash_meta_branch_under_grad(monkeypatch):
    """Under grad the meta branch goes through ``_FlashFn``: the forward
    with its lse, the backward's gradients at their inputs' shapes and
    10 D flops a kept pair."""
    monkeypatch.setattr(flash_ops, "mha_ref", _raise)
    b, h, hkv, s, d = 2, 4, 2, 24, 16
    q = torch.empty((b, s, h, d), device=META, requires_grad=True)
    k = torch.empty((b, s, hkv, d), device=META, requires_grad=True)
    v = torch.empty((b, s, hkv, d), device=META, requires_grad=True)
    with cost_analysis.CostCounter() as counter:
        out = flash_ops.mha(q, k, v, causal=True)
        dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    for g, x in ((dq, q), (dk, k), (dv, v)):
        assert (g.shape, g.dtype, g.device) == (x.shape, x.dtype, META)
    kept = _kept(s, True, 0, 0)
    rows = counter.costs.kernels
    assert rows["flash_attention"]["flops"] == 4 * d * b * h * kept
    assert rows["flash_attention"]["hbm_bytes"] == 4 * (
        2 * b * s * h * d + 2 * b * s * hkv * d + b * h * s)   # with lse
    assert rows["flash_attention_bwd"] == {
        "calls": 1, "flops": 10 * d * b * h * kept,
        "hbm_bytes": 4 * (3 * b * s * h * d + 2 * b * s * hkv * d
                          + b * h * s + b * s * (h + 2 * hkv) * d),
        "masked_flops": 10 * d * b * h * (s * s - kept)}
    assert flash_ops.flash_attention.launches == 0


def _scan_inputs(bsz, t, d_in, ds):
    gen = torch.Generator().manual_seed(1)
    u = torch.randn((bsz, t, d_in), generator=gen)
    dt = torch.rand((bsz, t, d_in), generator=gen) * 0.1
    bm = torch.randn((bsz, t, ds), generator=gen)
    cm = torch.randn((bsz, t, ds), generator=gen)
    a = -torch.rand((d_in, ds), generator=gen)
    dsk = torch.rand(d_in, generator=gen)
    return u, dt, bm, cm, a, dsk


@pytest.mark.parametrize("shape", [(2, 37, 12, 4), (1, 300, 8, 16)])
def test_scan_meta_branch_reports_its_cost(monkeypatch, shape):
    bsz, t, d_in, ds = shape
    inputs = _scan_inputs(*shape)
    cpu, cpu_costs = _reported(lambda: ssm_ops.ssm_scan(*inputs))
    monkeypatch.setattr(ssm_ops, "ssm_scan_ref", _raise)
    meta = _meta(*inputs)
    got, costs = _reported(lambda: ssm_ops.ssm_scan(*meta))
    _same_layout(got, cpu)
    n = bsz * t * d_in
    words = (2 * n + 2 * bsz * t * ds + d_in * ds + d_in   # inputs
             + n + bsz * d_in * ds)                        # y, final h
    want = {"calls": 1, "flops": 5 * n * ds + 3 * n, "hbm_bytes": 4 * words,
            "masked_flops": 0.0}
    assert costs.kernels == {"ssm_scan": want}
    assert cpu_costs.kernels == costs.kernels

    # under grad: the chunk states written, then the backward kernel
    leaves = [torch.empty(x.shape, device=META, requires_grad=True)
              for x in inputs]
    with cost_analysis.CostCounter() as counter:
        y, h = ssm_ops.ssm_scan(*leaves)
        grads = torch.autograd.grad(y.sum() + h.sum(), leaves)
    for g, x in zip(grads, leaves):
        assert (g.shape, g.device) == (x.shape, META)
    chunks = bsz * -(-t // 16) * d_in * ds
    rows = counter.costs.kernels
    assert rows["ssm_scan"]["hbm_bytes"] == 4 * (words + chunks)
    inputs_words = 2 * n + 2 * bsz * t * ds + d_in * ds + d_in
    assert rows["ssm_scan_bwd"] == {
        "calls": 1, "flops": 2 * (5 * n * ds + 3 * n),
        "hbm_bytes": 4 * (2 * inputs_words + chunks + n + bsz * d_in * ds),
        "masked_flops": 0.0}


@pytest.mark.parametrize("noisy", [False, True])
def test_fl_kernels_meta_branches_report_their_cost(monkeypatch, noisy):
    c, n, r = 5, 37, 3
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((c, n), generator=gen)
    w = torch.full((c,), 1.0 / c)
    noise = torch.randn((c, n), generator=gen) if noisy else None
    w_rows = torch.rand((r, c), generator=gen)
    calls = {
        "fedavg_flat": (lambda x, w, nz, wr: fedavg_ops.fedavg_flat(x, w, nz),
                        (2 + noisy) * c * n,
                        4 * ((2 + noisy) * c * n + c)),
        "mix_rows_flat": (lambda x, w, nz, wr: fedavg_ops.mix_rows_flat(
            wr, x), 2 * r * c * n, 4 * (r * c + c * n + r * n)),
        "digest_div_flat": (lambda x, w, nz, wr: fedavg_ops.digest_div_flat(
            x), 4 * c * n, 4 * (c * n + c + 1)),
    }
    cpu = {}
    for name, (fn, _, _) in calls.items():
        cpu[name] = _reported(lambda: fn(x, w, noise, w_rows))
    for ref in ("fedavg_flat_ref", "mix_rows_flat_ref",
                "digest_div_flat_ref"):
        monkeypatch.setattr(fedavg_ops, ref, _raise)
    mx, mw, mwr = _meta(x, w, w_rows)
    mnoise = _meta(noise)[0] if noisy else None
    for name, (fn, flops, nbytes) in calls.items():
        got, costs = _reported(lambda: fn(mx, mw, mnoise, mwr))
        _same_layout(got, cpu[name][0])
        want = {"calls": 1, "flops": flops, "hbm_bytes": nbytes,
                "masked_flops": 0.0}
        assert costs.kernels == {name: want}, name
        assert cpu[name][1].kernels == costs.kernels, name


@pytest.mark.parametrize("payloads", [False, True])
def test_mine_kernel_meta_branches_report_their_cost(monkeypatch,
                                                     payloads):
    c, attempts = 7, 300

    def word(v, dev):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    def calls(dev):
        pay = (torch.arange(c, dtype=torch.int64, device=dev) * 977
               if payloads else None)
        race = (lambda: pow_ops.pow_race_flat(
            word(5, dev), torch.arange(c, dtype=torch.int64, device=dev),
            word(64, dev), attempts))
        seal = (lambda: pow_ops.mine_seal(
            word(5, dev), word(123, dev), c, attempts,
            nonce_offset=word(64, dev), difficulty_bits=4, payloads=pay))
        return {"pow_race": race, "mine_seal": seal}

    cpu = {name: _reported(fn) for name, fn in calls("cpu").items()}
    monkeypatch.setattr(pow_ops, "pow_race_ref", _raise)
    monkeypatch.setattr(pow_ops, "mine_seal_ref", _raise)
    words = {"pow_race": 8 * (3 * c + 2),
             "mine_seal": 8 * (3 + (c if payloads else 0) + 4) + 1}
    for name, fn in calls(META).items():
        got, costs = _reported(fn)
        if name == "mine_seal":
            metrics, new_hash = got
            want_metrics, want_hash = cpu[name][0]
            _same_layout([metrics[k] for k in sorted(metrics)] + [new_hash],
                         [want_metrics[k] for k in sorted(metrics)]
                         + [want_hash])
        else:
            _same_layout(got, cpu[name][0])
        assert costs.kernels == {name: {
            "calls": 1, "flops": 12 * c * attempts,
            "hbm_bytes": words[name], "masked_flops": 0.0}}, name
        assert cpu[name][1].kernels == costs.kernels, name
    assert pow_ops.pow_race_flat.launches == 0
