"""A run with the timed path broken underneath comes out not correct,
once for each fault a training job can have on one chip, and so does the
control: the reference a precision lower in the program's place (TF32,
emulated on the CPU by rounding each product's fp32 inputs to TF32's 10
mantissa bits). Each drives the rest of a run (``run.measure``) on the
CPU at smoke size, past the look for a card."""
import pytest
import torch
from torch.overrides import TorchFunctionMode

from fl_bench import check, harness, run
from fl_bench.tests.conftest import smoke_cell

CPU = torch.device("cpu")
SEED = 2 ** 32 + 11


def measure(cell=None):
    result, checks = run.measure(cell or smoke_cell(), SEED, 0.01, False,
                                 CPU, 0.0)
    return result["correct"], {k: c["value"] for k, c in checks.items()}


def test_sound_run_is_correct():
    correct, values = measure()
    assert correct, values


def test_state_left_unchanged(monkeypatch):
    from repro_torch.core import rounds

    def make_local_train(loss_fn, spec):
        def local_train(params, batch):
            with torch.no_grad():
                return params, loss_fn(params, batch)
        return local_train

    monkeypatch.setattr(rounds, "make_local_train", make_local_train)
    correct, values = measure()
    assert not correct
    assert values["update_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.models import registry

    whole = registry.client_losses

    def client_losses(cfg, *a, **k):
        losses = whole(cfg, *a, **k)

        def half(params, batch):
            return losses(params, {n: v[:, : v.shape[1] // 2]
                                   for n, v in batch.items()})
        return half

    monkeypatch.setattr(registry, "client_losses", client_losses)
    correct, values = measure()
    assert not correct
    assert values["loss_gap"] > smoke_cell().limits["loss_gap"]


def test_answer_altered_where_produced(monkeypatch):
    from repro_torch.kernels.pow_hash import ops

    seal = ops.mine_seal

    def altered(*a, **k):
        metrics, new_hash = seal(*a, **k)
        return {**metrics, "nonce": metrics["nonce"] ^ 1}, new_hash

    monkeypatch.setattr(ops, "mine_seal", altered)
    correct, values = measure()
    assert not correct
    assert values["mine_mismatch"] >= 1


def test_digest_altered_where_produced(monkeypatch):
    """The digest sweep's leaf sums taken over half of each leaf: the race
    and the ledger follow the wrong digest, so only the sums show it."""
    from repro_torch.kernels.fedavg import ops

    sweep = ops.digest_div_flat

    def partial(x):
        total, residuals = sweep(x)
        return x[:, : x.shape[1] // 2].sum(), residuals

    monkeypatch.setattr(ops, "digest_div_flat",
                        harness.StandIn(sweep, partial))
    correct, values = measure()
    assert not correct
    assert values["mine_mismatch"] == 0
    assert values["digest_gap"] > smoke_cell().limits["digest_gap"]


def test_digest_not_the_fold_of_its_sums(monkeypatch):
    """A digest folded from other sums than the sweep returned."""
    from repro_torch.core import mining

    fold = mining.fold_digest
    monkeypatch.setattr(mining, "fold_digest",
                        lambda acc, s: fold(acc, s * 2))
    correct, values = measure()
    assert not correct
    assert values["mine_mismatch"] >= 1


class RoundTF32(torch.autograd.Function):
    """x rounded to TF32's 10 mantissa bits (to nearest); the gradient
    passes through."""

    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g


class EmulatedTF32(TorchFunctionMode):
    """The forward's fp32 products with their inputs rounded to TF32, as
    the tensor cores take them with TF32 on."""
    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.einsum, torch.bmm, torch.mm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(RoundTF32.apply(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **(kwargs or {}))


def test_control_fails():
    """The reference in TF32 against the reference in fp32, judged by the
    phi4 cell's limits, on the cell's sequence length at smoke widths."""
    cell = smoke_cell(seq=512, rounds=2)
    w = harness.make_weights(SEED, cell, CPU)
    tokens = harness.make_batch(SEED, 0, cell, 2, CPU)
    want = check.reference_job(cell, w, tokens)
    with EmulatedTF32():
        got = check.reference_job(cell, w, tokens)
    values = check.numbers(got, want)
    values["mine_mismatch"] = 0
    correct, _ = check.judge(values, cell.limits)
    assert not correct, values
