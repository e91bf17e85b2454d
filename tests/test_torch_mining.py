"""The port's mining, race and ledger against the JAX package: bitwise.

Integer paths carry the ledger, so every comparison here is exact: the
same uint32 words from numpy go through ``repro.core.mining`` (and the
Pallas race in interpret mode) and through ``repro_torch``'s plain path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import chain as jchain
from repro.core import mining as jmining
from repro.kernels.pow_hash.kernel import pow_race_kernel, pow_search_kernel
from repro_torch.core import chain, mining
from repro_torch.kernels.pow_hash import ops as pow_ops

# the budgets pinned by tests/test_kernels.py (POW_GRID_CASES): divisible,
# non-divisible tails, chunk larger than the budget, odd chunk
POW_GRID_CASES = [(4096, 512), (3000, 1024), (1500, 1024), (100, 64),
                  (1, 16), (1000, 384)]


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)


def _t(words):
    return torch.as_tensor(np.asarray(words, np.uint64).astype(np.int64))


def _j(words):
    return jnp.asarray(np.asarray(words, np.uint64).astype(np.uint32))


def test_mix_hash_and_avalanche_bitwise():
    a, b, c = _words(4096, 0), _words(4096, 1), _words(4096, 2)
    want = np.asarray(jmining.mix_hash(_j(a), _j(b), _j(c)), np.uint64)
    got = mining.mix_hash(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    want_av = np.asarray(jmining._avalanche(_j(a)), np.uint64)
    np.testing.assert_array_equal(mining._avalanche(_t(a)).numpy(),
                                  want_av.astype(np.int64))


def test_mul32_edges_bitwise():
    edges = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                      0xFFFFFFFF], np.uint64)
    for m in (mining._M1, mining._M2, mining._M3):
        want = (edges.astype(object) * m) % (1 << 32)
        got = mining._mul32(_t(edges), m).numpy()
        np.testing.assert_array_equal(got, np.array(want, np.int64))


def test_client_salt_bitwise():
    ids = np.arange(64, dtype=np.uint64)
    want = np.asarray(jmining.client_salt(jnp.arange(64, dtype=jnp.uint32)),
                      np.uint64)
    np.testing.assert_array_equal(mining.client_salt(_t(ids)).numpy(),
                                  want.astype(np.int64))


def test_fold_digest_bitwise_given_equal_sums():
    rng = np.random.default_rng(3)
    sums = np.concatenate([rng.normal(size=32).astype(np.float32) * 1e3,
                           np.array([0.0, -0.0, 1.0, -1.0, 3.4e38],
                                    np.float32)])
    jacc = jnp.uint32(jmining.DIGEST_INIT)
    acc = mining.as_word(mining.DIGEST_INIT)
    for s in sums:
        jacc = jmining.fold_digest(jacc, jnp.float32(s))
        acc = mining.fold_digest(acc, torch.tensor(s, dtype=torch.float32))
        assert int(acc) == int(jacc)


def test_digest_tree_leaf_sums_close_and_fold_exact():
    """digest_tree's leaf sums agree at fp32 tolerance (the summation order
    differs); folding the reference's own sums reproduces its digest."""
    rng = np.random.default_rng(4)
    tree = {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in {"b1": (3, 8), "w1": (3, 5, 8), "w2": (3, 8, 2),
                             "b2": (3, 2)}.items()}
    for k in sorted(tree):
        want = float(jnp.sum(jnp.asarray(tree[k])))
        got = float(torch.as_tensor(tree[k]).sum())
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(tree[k]).sum())
    jdigest = int(jmining.digest_tree({k: jnp.asarray(v)
                                       for k, v in tree.items()}))
    acc = mining.as_word(mining.DIGEST_INIT)
    for k in sorted(tree):   # jax.tree.leaves order of a dict = sorted keys
        s = np.asarray(jnp.sum(jnp.asarray(tree[k])), np.float32)
        acc = mining.fold_digest(acc, torch.tensor(float(s)))
    assert int(acc) == jdigest


@pytest.mark.parametrize("case", POW_GRID_CASES,
                         ids=lambda c: f"n{c[0]}b{c[1]}")
def test_pow_search_bitwise(case):
    n, chunk = case
    for cid in (0, 3):
        jh, jn = jmining.pow_search(jnp.uint32(123), jnp.uint32(456),
                                    jnp.uint32(cid), n,
                                    nonce_offset=jnp.uint32(7 << 10),
                                    chunk=chunk)
        h, nn = mining.pow_search(123, 456, cid, n, nonce_offset=7 << 10,
                                  chunk=chunk)
        assert (int(h), int(nn)) == (int(jh), int(jn))


@pytest.mark.parametrize("case", POW_GRID_CASES,
                         ids=lambda c: f"n{c[0]}b{c[1]}")
def test_pow_race_plain_matches_pallas_race_bitwise(case):
    n, chunk = case
    ids = np.arange(3, dtype=np.uint64)
    prev, digest, off = 0xDEADBEEF, 0x12345678, (5 << 20) + 0xFFFFF000
    off &= 0xFFFFFFFF   # offset + local wraps past 2**32 inside the budget
    payloads = (digest ^ np.asarray(jmining.client_salt(
        jnp.asarray(ids.astype(np.uint32))), np.uint64))
    jh, jn = pow_race_kernel(jnp.uint32(prev), _j(payloads), jnp.uint32(off),
                             n, block=chunk, interpret=True)
    h, nn = pow_ops.pow_race_flat(mining.as_word(prev), _t(payloads),
                                  mining.as_word(off), n, chunk=chunk)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh, np.int64))
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jn, np.int64))
    # the salting wrapper and the per-client reference search agree too
    h2, n2 = pow_ops.pow_race(mining.as_word(prev), mining.as_word(digest),
                              _t(ids), n, nonce_offset=mining.as_word(off),
                              chunk=chunk)
    np.testing.assert_array_equal(h2.numpy(), h.numpy())
    for c in range(3):
        rh, rn = jmining.pow_search(jnp.uint32(prev), jnp.uint32(digest),
                                    jnp.uint32(c), n,
                                    nonce_offset=jnp.uint32(off), chunk=chunk)
        assert (int(h2[c]), int(n2[c])) == (int(rh), int(rn))


@pytest.mark.parametrize("n", [1, 100, 2500])
def test_single_client_mine_matches_pow_search_kernel(n):
    prev, digest, cid, off = 99, 0xCAFEF00D, 7, 3 << 20
    salted = digest ^ int(jmining.client_salt(jnp.uint32(cid)))
    jh, jn = pow_search_kernel(jnp.uint32(prev), jnp.uint32(salted),
                               jnp.uint32(off), n, block=1024, interpret=True)
    h, nn = pow_ops.mine(mining.as_word(prev), mining.as_word(digest),
                         mining.as_word(cid), n,
                         nonce_offset=mining.as_word(off))
    assert (int(h), int(nn)) == (int(jh), int(jn))


def test_race_keeps_nonce_zero_when_no_hash_beats_max(monkeypatch):
    """The reference's running min starts at (0xFFFFFFFF, nonce 0) with a
    strict '<', so a client whose every hash is 0xFFFFFFFF keeps nonce 0.
    Force that case through both packages with a saturated hash."""
    monkeypatch.setattr(jmining, "mix_hash",
                        lambda p, q, n: jnp.full(jnp.shape(n), 0xFFFFFFFF,
                                                 jnp.uint32))
    monkeypatch.setattr(mining, "mix_hash",
                        lambda p, q, n: torch.full(torch.broadcast_shapes(
                            p.shape, q.shape, n.shape), mining.MASK,
                            dtype=torch.int64))
    jh, jn = jmining.pow_search(jnp.uint32(1), jnp.uint32(2), jnp.uint32(0),
                                300, nonce_offset=jnp.uint32(77), chunk=128)
    h, n = pow_ops.pow_race_flat(mining.as_word(1), _t([2, 3]),
                                 mining.as_word(77), 300, chunk=128)
    assert (int(jh), int(jn)) == (mining.MASK, 0)
    assert h.tolist() == [mining.MASK] * 2 and n.tolist() == [0, 0]


def test_winner_and_threshold_match():
    rng = np.random.default_rng(5)
    hs = rng.integers(0, 50, 40, dtype=np.uint64)   # many ties
    assert int(mining.winner_of(_t(hs))) == int(jmining.winner_of(_j(hs)))
    for bits in (0, 4, 8, 31):
        assert mining.difficulty_threshold(bits) == \
            int(jmining.difficulty_threshold(bits))


def test_pow_wrapper_validates_inputs():
    good = mining.as_word(1)
    with pytest.raises(TypeError):
        pow_ops.pow_race_flat(good, torch.zeros(3, dtype=torch.int32), good, 8)
    with pytest.raises(ValueError):
        pow_ops.pow_race_flat(good, torch.zeros(3, dtype=torch.int64), good, 0)
    with pytest.raises(ValueError):
        pow_ops.pow_race_flat(good.to("meta"),
                              torch.zeros(3, dtype=torch.int64,
                                          device="meta"),
                              good.to("meta"), 8)


def test_chain_header_hashes_equal_and_validate():
    rng = np.random.default_rng(6)
    fields = rng.integers(0, 2 ** 32, (5, 4), dtype=np.uint64)
    assert chain.GENESIS_HASH == jchain.GENESIS_HASH
    led, jled = chain.Ledger(difficulty_bits=0), jchain.Ledger()
    for i, (d, w, n, p) in enumerate(fields.tolist()):
        b = chain.make_block(i, led.head_hash, d, w % 20, n, p)
        jb = jchain.make_block(i, jled.head_hash, d, w % 20, n, p)
        assert b.header_hash == jb.header_hash
        led.append(b)
        jled.append(jb)
    assert led.validate_chain() and led.head_hash == jled.head_hash
    rebuilt = chain.ledger_from_scan(*fields.T)
    assert rebuilt.head_hash == jchain.ledger_from_scan(*fields.T).head_hash
    bumped = (led.blocks[2].model_digest + 1) & mining.MASK
    assert not led.tampered_copy(2, model_digest=bumped).validate_chain()

