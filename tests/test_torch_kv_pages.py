"""The port's paged KV cache against the JAX package's: the host allocator
(the same admit/ensure/release programs give the same page tables, free
lists and refusals, including a hypothesis property), the device ops
(paged write, gather and ``scatter_row_blocks``, with every write through
an unmapped page landing in the spare block), ``paged_decode_attention``
and the per-slot ``decode_attention`` (<= 1e-5 of max |x|), the dense view
of a live paged engine, and pool pressure deferring admissions without
dropping one."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jl                        # noqa: E402
from repro.serving import PageAllocator as JaxAllocator      # noqa: E402
from repro.serving import PageOOM as JaxOOM                  # noqa: E402
from repro.serving import kv_pages as jkv                    # noqa: E402
from repro_torch.configs.paper_models import BERT_SMALL      # noqa: E402
from repro_torch.models import layers as tl                  # noqa: E402
from repro_torch.models.model import init_params             # noqa: E402
from repro_torch.serving import PageAllocator, PageOOM, ServingEngine  # noqa: E402
from repro_torch.serving import kv_pages as tkv              # noqa: E402

TINY = BERT_SMALL.scaled(
    name="kvp-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    objective="clm", encoder_only=False, causal=True)


# ---------------------------------------------------------------------------
# Allocator: one program through both packages
# ---------------------------------------------------------------------------
def _step(a, oom, op, slot, length, live):
    """Apply one (op, slot, length) to allocator ``a``; returns what it did
    (the outcome both packages must agree on)."""
    if op == "admit" and slot not in live:
        try:
            a.admit(slot, min(length, a.block_size), length)
        except oom:
            return "oom"
        live.add(slot)
        return "admitted"
    if op == "ensure" and slot in live:
        try:
            a.ensure(slot, min(length, int(a.reserved[slot]) * a.block_size))
        except oom:
            return "oom"
        return "ensured"
    if op == "release" and slot in live:
        a.release(slot)
        live.discard(slot)
        return "released"
    return "skip"


def _same_program(slots, max_len, bs, pool, ops_):
    ours, theirs = (PageAllocator(slots, max_len, bs, pool_blocks=pool),
                    JaxAllocator(slots, max_len, bs, pool_blocks=pool))
    live_o, live_t = set(), set()
    for op, slot, length in ops_:
        assert (_step(ours, PageOOM, op, slot, length, live_o)
                == _step(theirs, JaxOOM, op, slot, length, live_t))
        np.testing.assert_array_equal(ours.table, theirs.table)
        assert ours.free == theirs.free
        np.testing.assert_array_equal(ours.reserved, theirs.reserved)
        np.testing.assert_array_equal(ours.allocated, theirs.allocated)
        assert ours.peak_blocks == theirs.peak_blocks
        assert ours.can_admit(max_len) == theirs.can_admit(max_len)
    np.testing.assert_array_equal(ours.device_table().numpy(),
                                  np.asarray(theirs.device_table()))


def test_allocator_random_programs_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(30):
        slots = int(rng.randint(1, 5))
        max_len = int(rng.randint(4, 64))
        bs = int(rng.choice([1, 4, 16]))
        pool = int(rng.randint(-(-max_len // bs),
                               slots * -(-max_len // bs) + 1))
        ops_ = [(str(rng.choice(["admit", "ensure", "release"])),
                 int(rng.randint(0, slots)), int(rng.randint(1, max_len + 1)))
                for _ in range(40)]
        _same_program(slots, max_len, bs, pool, ops_)


def test_allocator_hypothesis_property_matches_jax():
    from hypothesis import given, settings, strategies as st

    op = st.tuples(st.sampled_from(["admit", "ensure", "release"]),
                   st.integers(0, 3), st.integers(1, 48))

    @given(ops_=st.lists(op, min_size=1, max_size=60),
           bs=st.sampled_from([1, 3, 8, 16]),
           pool_frac=st.floats(0.34, 1.0))
    @settings(max_examples=50, deadline=None, database=None)
    def prop(ops_, bs, pool_frac):
        max_pages = -(-48 // bs)
        _same_program(4, 48, bs, max(max_pages, int(4 * max_pages
                                                    * pool_frac)), ops_)

    prop()


def test_allocator_refuses_a_pool_smaller_than_one_slot():
    with pytest.raises(ValueError, match="pool smaller"):
        PageAllocator(2, 32, 8, pool_blocks=3)


def test_device_table_is_copied_only_when_dirty():
    a = PageAllocator(2, 32, 8)
    t0 = a.device_table()
    assert a.device_table() is t0 and t0.dtype == torch.long
    a.admit(0, 8, 16)
    t1 = a.device_table()
    assert t1 is not t0 and int(t1[0, 0]) == int(a.table[0, 0])


# ---------------------------------------------------------------------------
# Device ops against the JAX package's
# ---------------------------------------------------------------------------
def test_paged_write_gather_roundtrip_matches_jax():
    """Writes through both packages' pools: the real blocks agree bit for
    bit after every write, the gathered view over mapped positions is the
    dense history, and a write through slot 0's unmapped third page lands
    in the port's spare block (JAX drops it) and nowhere else."""
    bs, n_blocks, KV, dh, B, P = 4, 8, 2, 3, 2, 3
    rng = np.random.RandomState(1)
    jpool = jnp.zeros((n_blocks, bs, KV, dh), jnp.float32)
    tpool = torch.zeros((n_blocks + 1, bs, KV, dh))
    table = np.asarray([[0, 1, -1], [2, 3, 4]], np.int32)
    jpages, tpages = jnp.asarray(table), torch.as_tensor(table).long()
    dense = np.zeros((B, P * bs, KV, dh), np.float32)
    for pos in range(3 * bs):       # the last bs: slot 0's unmapped page
        kv = rng.randn(B, 1, KV, dh).astype(np.float32)
        jpool = jkv.write_token_paged(jpool, jpages,
                                      jnp.full((B,), pos, jnp.int32),
                                      jnp.asarray(kv))
        spare = tpool[-1].clone()
        tkv.write_token_paged(tpool, tpages, torch.full((B,), pos),
                              torch.as_tensor(kv))
        np.testing.assert_array_equal(tpool[:n_blocks].numpy(),
                                      np.asarray(jpool))
        if pos >= 2 * bs:
            assert torch.equal(tpool[-1, pos % bs], torch.as_tensor(kv[0, 0]))
        else:
            assert torch.equal(tpool[-1], spare)
        dense[:, pos] = kv[:, 0]
    got = tkv.gather_pages(tpool, tpages).numpy()
    np.testing.assert_array_equal(got[0, :2 * bs], dense[0, :2 * bs])
    np.testing.assert_array_equal(got[1], dense[1])
    # an unmapped page reads the spare block, the pool's last
    np.testing.assert_array_equal(got[0, 2 * bs:],
                                  tpool[-1].numpy())


def test_scatter_row_blocks_matches_jax():
    L, n_blocks, bs, KV, dh, P = 2, 6, 4, 2, 3, 2
    rng = np.random.RandomState(2)
    start = rng.randn(L, n_blocks, bs, KV, dh).astype(np.float32)
    row = rng.randn(L, P * bs, KV, dh).astype(np.float32)
    pages = np.asarray([3, -1], np.int32)
    want = np.asarray(jkv.scatter_row_blocks(
        jnp.asarray(start), jnp.asarray(pages), jnp.asarray(row)))
    tpool = torch.as_tensor(np.concatenate(
        [start, np.zeros((L, 1, bs, KV, dh), np.float32)], 1))
    tkv.scatter_row_blocks(tpool, torch.as_tensor(pages).long(),
                           torch.as_tensor(row))
    np.testing.assert_array_equal(tpool[:, :n_blocks].numpy(), want)
    # the unmapped page's block went to the spare
    np.testing.assert_array_equal(tpool[:, -1].numpy(),
                                  row.reshape(L, P, bs, KV, dh)[:, 1])


def _rel_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("window,ring", [(0, False), (5, False), (8, True)])
def test_per_slot_decode_attention_matches_jax(window, ring):
    B, H, KV, dh, S = 3, 4, 2, 8, 8
    rng = np.random.RandomState(3)
    q = rng.randn(B, 1, H, dh).astype(np.float32)
    k = rng.randn(B, S, KV, dh).astype(np.float32)
    v = rng.randn(B, S, KV, dh).astype(np.float32)
    cur = np.asarray([1, 5, 8])
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(cur, jnp.int32), window=window,
                               ring=ring)
    got = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), torch.as_tensor(cur),
                              window=window, ring=ring)
    _rel_close(got.numpy(), want)
    # a (B,) length equal for every row is the int path, bit for bit
    same = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), torch.full((B,), 5),
                               window=window, ring=ring)
    lock = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), 5, window=window,
                               ring=ring)
    assert torch.equal(same, lock)


def test_paged_decode_attention_matches_jax():
    B, H, KV, dh, bs, n_blocks = 3, 4, 2, 8, 4, 9
    rng = np.random.RandomState(4)
    q = rng.randn(B, 1, H, dh).astype(np.float32)
    kp = rng.randn(n_blocks, bs, KV, dh).astype(np.float32)
    vp = rng.randn(n_blocks, bs, KV, dh).astype(np.float32)
    table = np.asarray([[5, -1, -1], [0, 7, 2], [3, 1, -1]], np.int32)
    cur = np.asarray([3, 11, 6])
    want = jl.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(cur, jnp.int32))
    # the port's pools carry the spare block last (JAX's -1 wraps to its
    # last real block instead: masked positions either way)
    spare = rng.randn(1, bs, KV, dh).astype(np.float32)
    got = tl.paged_decode_attention(
        torch.as_tensor(q), torch.as_tensor(np.concatenate([kp, spare])),
        torch.as_tensor(np.concatenate([vp, spare])),
        torch.as_tensor(table).long(), torch.as_tensor(cur))
    _rel_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# The paged engine inside the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    return init_params(TINY, torch.Generator().manual_seed(0), device="cpu")


def _submit(eng, lengths):
    rng = np.random.RandomState(0)
    return [eng.submit(list(rng.randint(0, TINY.vocab_size, n)), max_new=8)
            for n in lengths]


def test_gathered_dense_view_matches_engine_history(params):
    """The dense view of a live paged engine's pools equals the dense
    engine's cache over every valid position."""
    pe, de = (ServingEngine(params, TINY, slots=2, prompt_budget=8,
                            gen_budget=8, kv_layout=lay, device="cpu")
              for lay in ("paged", "dense"))
    for eng in (pe, de):
        _submit(eng, [5, 6])
        for _ in range(3):
            eng.step()
    view = tkv.gathered_dense_view(pe.state["caches"]["k"],
                                   pe.alloc.device_table()).numpy()
    dense = de.state["caches"]["k"].numpy()
    for s in range(2):
        n = int(pe.pos_host[s])
        assert n == int(de.pos_host[s]) and n > 0
        np.testing.assert_array_equal(view[:, s, :n], dense[:, s, :n])


def test_pool_pressure_defers_but_never_drops(params):
    """A pool that fits one worst-case request at a time serves every
    request to completion: admission defers, nothing drops."""
    eng = ServingEngine(params, TINY, slots=2, prompt_budget=8, gen_budget=8,
                        kv_layout="paged", block_size=4, pool_blocks=4,
                        device="cpu")
    reqs = _submit(eng, [6] * 4)
    deferred = False
    for _ in range(400):
        if not eng.has_work():
            break
        eng.step()
        deferred |= (len(eng.queue) > 0
                     and any(r is None for r in eng.slot_req))
    assert all(r.status == "done" for r in reqs)
    assert eng.counts()["dropped"] == 0 and eng.queue.rejected == 0
    assert deferred
    assert eng.alloc.peak_blocks <= 4
