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
from repro_torch.kernels.pow_hash import ref as pow_ref
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

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
    # meta tensors take the dry-run's branch: outputs of the kernel's
    # shapes, no launch; a device that is neither cpu, cuda nor meta raises
    before = pow_ops.pow_race_flat.launches
    h, n = pow_ops.pow_race_flat(good.to("meta"),
                                 torch.zeros(3, dtype=torch.int64,
                                             device="meta"),
                                 good.to("meta"), 8)
    assert all(x.device.type == "meta" and x.shape == (3,)
               and x.dtype == torch.int64 for x in (h, n))
    assert pow_ops.pow_race_flat.launches == before
    with pytest.raises(ValueError):
        pow_ops._check_race(torch.device("xpu"), 3, 8, None)


def _jax_seal(prev, digest, payloads, off, n, chunk, bits):
    """The JAX package's stage on pre-salted payloads and any nonce offset:
    its Pallas race in interpret mode, ``winner_of``, the difficulty test
    and ``mix_hash`` with the unsalted digest."""
    jh, jn = pow_race_kernel(jnp.uint32(prev), _j(payloads), jnp.uint32(off),
                             n, block=chunk, interpret=True)
    w = jmining.winner_of(jh)
    new = jmining.mix_hash(jnp.uint32(prev), jnp.uint32(digest), jn[w])
    return (int(w), int(jh[w]), int(jn[w]),
            bool(jh[w] <= jmining.difficulty_threshold(bits)), int(new))


def _seal_tuple(got):
    m, new = got
    return (int(m["winner"]), int(m["pow_hash"]), int(m["nonce"]),
            bool(m["solved"]), int(new))


def _salted(digest, n_clients):
    salts = np.asarray(jmining.client_salt(jnp.arange(n_clients,
                                                      dtype=jnp.uint32)),
                       np.uint64)
    return np.uint64(digest) ^ salts


@pytest.mark.parametrize("n_clients", [1, 7, 20])
def test_mine_seal_with_wrapping_offset_matches_reference(n_clients):
    """Nonces off + j that wrap past 2**32 inside the budget, in both of
    the seal's payload forms: salted by the wrapper and pre-salted."""
    prev, digest, bits = 0xDEADBEEF, 0x0BADF00D, 4
    off, n, chunk = 0xFFFFFFFF - 100, 300, 128
    want = _jax_seal(prev, digest, _salted(digest, n_clients), off, n, chunk,
                     bits)
    kw = dict(nonce_offset=mining.as_word(off), difficulty_bits=bits)
    got = pow_ops.mine_seal(mining.as_word(prev), mining.as_word(digest),
                            n_clients, n, **kw)
    assert _seal_tuple(got) == want
    got = pow_ops.mine_seal(mining.as_word(prev), mining.as_word(digest),
                            n_clients, n, chunk=chunk,
                            payloads=_t(_salted(digest, n_clients)), **kw)
    assert _seal_tuple(got) == want


def test_seal_picks_the_lowest_client_on_planted_ties():
    """Pre-salted payloads where clients 2, 5 and 6 carry the best payload
    (and tie on every hash): the first of them wins, as JAX's argmin
    picks."""
    prev, digest, off, n = 17, 23, 3 << 20, 500
    payloads = _words(8, 9)
    jh, _ = pow_race_kernel(jnp.uint32(prev), _j(payloads), jnp.uint32(off),
                            n, block=128, interpret=True)
    best = int(np.argmin(np.asarray(jh, np.uint64)))
    worst = int(np.argmax(np.asarray(jh, np.uint64)))
    planted = payloads.copy()
    planted[best] = payloads[worst]
    planted[[2, 5, 6]] = payloads[best]
    want = _jax_seal(prev, digest, planted, off, n, 128, 8)
    got = pow_ops.mine_seal(mining.as_word(prev), mining.as_word(digest), 8,
                            n, nonce_offset=mining.as_word(off),
                            difficulty_bits=8, payloads=_t(planted))
    assert _seal_tuple(got) == want
    assert want[0] == 2


def test_real_max_hash_keeps_nonce_zero_in_both_modes():
    """Payloads whose one hash is 0xFFFFFFFF (a budget of one attempt), made
    by inverting the hash: every client keeps nonce 0 in the race, the JAX
    Pallas kernel's and ``pow_search``'s too, and the seal links nonce 0."""
    prev, off = 0x12345678, 0xFFFFFFF0
    payload = pow_ref.payload_hashing_to(prev, off, mining.MASK)
    assert int(jmining.mix_hash(jnp.uint32(prev), jnp.uint32(payload),
                                jnp.uint32(off))) == mining.MASK
    payloads = np.full(3, payload, np.uint64)
    jh, jn = pow_race_kernel(jnp.uint32(prev), _j(payloads), jnp.uint32(off),
                             1, block=16, interpret=True)
    h, nn = pow_ops.pow_race_flat(mining.as_word(prev), _t(payloads),
                                  mining.as_word(off), 1)
    assert h.tolist() == np.asarray(jh, np.int64).tolist() == [mining.MASK] * 3
    assert nn.tolist() == np.asarray(jn, np.int64).tolist() == [0] * 3
    digest = 99
    for bits in (0, 4):
        want = _jax_seal(prev, digest, payloads, off, 1, 16, bits)
        got = pow_ops.mine_seal(mining.as_word(prev), mining.as_word(digest),
                                3, 1, nonce_offset=mining.as_word(off),
                                difficulty_bits=bits, payloads=_t(payloads))
        assert _seal_tuple(got) == want == (0, mining.MASK, 0, bits == 0,
                                            want[4])


def test_payload_hashing_to_inverts_the_hash():
    prev, nonce, target = (int(v) for v in _words(3, 12))
    for t in (target, 0, mining.MASK):
        q = pow_ref.payload_hashing_to(prev, nonce, t)
        assert int(jmining.mix_hash(jnp.uint32(prev), jnp.uint32(q),
                                    jnp.uint32(nonce))) == t


def test_race_tile_is_one_block_a_client_at_the_paper_budget():
    """At the paper's budget a client is one block (flat mode takes no
    ticket); larger budgets take several blocks a client, at most
    MAX_BLOCKS in all unless C alone needs more; a chunk forces the tile,
    raised only to bound the partial keys."""
    assert pow_ops.race_tile(10240, 20) == 10240
    assert pow_ops.race_tile(1, 65535) == 1
    n = 1 << 20
    tiles = -(-n // pow_ops.race_tile(n, 20))
    assert 1 < tiles and 20 * tiles <= pow_ops.MAX_BLOCKS
    assert pow_ops.race_tile(n, 5000) == n
    assert pow_ops.race_tile(10240, 20, chunk=1024) == 1024
    assert pow_ops.race_tile(100, 3, chunk=1024) == 100
    big = (1 << 31) - 1
    assert -(-big // pow_ops.race_tile(big, 1, chunk=1)) <= \
        pow_ops.MAX_BLOCKS << 10
    for n in (1, 16384, 16385, 40000, 10 ** 6, big):
        for c in (1, 20, 65535):
            for chunk in (None, 1, 1000):
                tile = pow_ops.race_tile(n, c, chunk)
                tiles = -(-n // tile)
                assert 1 <= tile <= n and tiles < 2 ** 31
                assert chunk is not None or c * tiles <= max(
                    c, pow_ops.MAX_BLOCKS)


_W = mining.as_word


@pytest.mark.parametrize("kwargs,error", [
    (dict(n_clients=0), ValueError), (dict(n_clients=65536), ValueError),
    (dict(n_attempts=0), ValueError), (dict(n_attempts=1 << 31), ValueError),
    (dict(chunk=0), ValueError), (dict(chunk=(1 << 24) + 1), ValueError),
    (dict(difficulty_bits=-1), ValueError),
    (dict(difficulty_bits=33), ValueError),
    (dict(digest=torch.zeros(2, dtype=torch.int64)), TypeError),
    (dict(prev_hash=torch.zeros((), dtype=torch.int32)), TypeError),
    (dict(payloads=torch.zeros(3, dtype=torch.int64)), TypeError),
    (dict(payloads=torch.zeros(4, dtype=torch.int32)), TypeError),
    (dict(nonce_offset=_W(0).to("meta")), ValueError),
    (dict(prev_hash=_W(0).to("meta"), digest=_W(0).to("meta"),
          nonce_offset=_W(0).to("meta")), None),
], ids=["c0", "c65536", "n0", "n2^31", "chunk0", "chunk2^24+1", "bits-1",
        "bits33", "digest-shape", "prev-dtype", "payloads-shape",
        "payloads-dtype", "offset-device", "meta-device"])
def test_mine_seal_validates_inputs(kwargs, error):
    """Each bad input raises; words all on the meta device take the
    dry-run's branch (``error`` None): the stage's outputs as meta
    tensors, no launch."""
    args = dict(prev_hash=_W(1), digest=_W(2), n_clients=4, n_attempts=8,
                nonce_offset=_W(0), difficulty_bits=4)
    args.update(kwargs)
    prev, digest = args.pop("prev_hash"), args.pop("digest")
    c, n = args.pop("n_clients"), args.pop("n_attempts")
    if error is None:
        before = pow_ops.pow_race_flat.launches
        metrics, new_hash = pow_ops.mine_seal(prev, digest, c, n, **args)
        assert all(v.device.type == "meta" and v.shape == ()
                   for v in [new_hash, *metrics.values()])
        assert metrics["solved"].dtype == torch.bool
        assert pow_ops.pow_race_flat.launches == before
        return
    with pytest.raises(error):
        pow_ops.mine_seal(prev, digest, c, n, **args)


def test_mine_seal_takes_every_difficulty_in_range():
    for bits in (0, 32):
        m, _ = pow_ops.mine_seal(_W(1), _W(2), 4, 8, nonce_offset=_W(0),
                                 difficulty_bits=bits)
        assert bool(m["solved"]) == (bits == 0)


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

