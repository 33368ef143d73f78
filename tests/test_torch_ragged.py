"""The resident path's ragged call: one launch and one D2H per burst.

The kernel (csrc/fused_reconstruct.cu) takes a work list of (request, span)
entries and a table of bit masks in its parameters; both are built on the
host and are held here on the CPU: the list covers every sub-request's
bytes exactly once inside the padded survivors, a numpy model of the
kernel's block -> (request, span) mapping and arithmetic writes each output
byte once and equals the plain version, the masks are the prepared
matrix's bits, and the ragged plain version equals the uniform plain
versions, the numpy oracle and, in one small case, the JAX package's
kernel (Pallas in interpret mode).  GF(256) is exact: every comparison is
byte equality.  The kernel itself is held against the plain version on the
card in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_resident as jr
from seaweedfs_tpu.ops import rs_tpu
from seaweedfs_tpu_torch.ops import rs_cpu, rs_cuda
from seaweedfs_tpu_torch.ops import rs_resident as tr

from test_rs_resident import coded  # noqa: F401 (fixture)
from test_torch_resident import _mixed_requests, _port_cache, _system

L_SURV = 1 << 20
GROUPS = 4


@pytest.fixture(scope="module")
def survivors():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, L_SURV, dtype=np.uint8) for _ in range(10)]


def _prepared(layout, w, device="cpu"):
    mat = _system(w)
    if layout == "flat":
        return mat, rs_cuda.prepare_matrix(mat, device), 1, tr.FUSED_ALIGN
    a = rs_cuda.prepare_matrix_blockdiag(mat, GROUPS, device)
    return mat, a, GROUPS, GROUPS * tr.FUSED_ALIGN


def _ragged_words(rng, n, w, unit, max_units=24):
    fetches = rng.integers(1, max_units + 1, n) * unit
    units = rng.integers(0, (L_SURV - fetches) // tr.FUSED_ALIGN + 1)
    units[-1] = (L_SURV - fetches[-1]) // tr.FUSED_ALIGN  # the last window
    words = (units << tr.META_ROW_BITS) | rng.integers(0, w, n)
    return words.astype(np.int64), fetches.astype(np.int64)


def _oracle(mat, survivors, word, fetch):
    start = (int(word) >> tr.META_ROW_BITS) * tr.FUSED_ALIGN
    row = int(word) & ((1 << tr.META_ROW_BITS) - 1)
    x = np.stack([s[start : start + fetch] for s in survivors])
    return rs_cpu.apply_matrix_numpy(mat[row : row + 1], x)[0]


# --- the work list ------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_work_list_covers_each_sub_request_once(coded, layout):  # noqa: F811
    """A _mixed_requests burst packs into one call; every sub-request's
    window lies inside the padded survivors and its [delta, delta+take)
    inside its own fetch; together the pieces are each request's bytes
    exactly once."""
    length = coded.shape[1]
    reqs = _mixed_requests(length)
    cache = _port_cache(coded, missing=(3, 11), layout=layout)
    calls, subs, *_rest, groups, tile = tr._pack_calls(
        cache, 7, reqs, layout, tr.DATA_SHARDS, tr.TOTAL_SHARDS)
    assert len(calls) == 1
    (part, words, fetches, deltas), = calls
    assert [j for j, _ in part] == list(range(len(subs)))
    padded = cache._padded_len(length)
    q = groups * tr.FUSED_ALIGN
    covered = [[] for _ in reqs]
    for (_, s), word, fetch, delta in zip(part, words, fetches, deltas):
        start = (word >> tr.META_ROW_BITS) * tr.FUSED_ALIGN
        assert fetch % q == 0 and fetch - q < delta + s[3] <= fetch
        assert 0 <= delta < tr.FUSED_ALIGN
        assert start + fetch <= padded
        assert start + delta == s[1] + s[2]  # the sub-request's first byte
        covered[s[0]].append((start + delta, s[3]))
    for (sid, off, size), pieces in zip(reqs, covered):
        pos = off
        for first, take in pieces:  # in order, back to back
            assert first == pos
            pos += take
        assert pos == off + size
    # the kernel's list covers each output byte once, in request order
    work = tr._work_list(words, fetches, groups, tile)
    spans = np.zeros(sum(fetches), dtype=np.int64)
    for x, y in work:
        out = (y >> tr._OUT_SHIFT) * tr.FUSED_ALIGN
        n = ((y & 3) + 1) * tr.FUSED_ALIGN
        spans[out : out + n] += 1
    assert (spans == 1).all()


def test_pack_calls_split_only_at_the_limits(monkeypatch):
    """A burst splits into more calls only where the work list would pass
    one launch or the output _MAX_CALL_OUT; every call stays within both."""
    rng = np.random.default_rng(2)
    reqs = [(0, int(rng.integers(0, 1 << 30)), int(rng.integers(1, 3 << 20)))
            for _ in range(200)]
    subs = tr._plan(reqs)
    calls = tr._ragged_calls(subs, reqs, {0: 0}, 1)
    blocks = [sum(-(-f // tr.RAGGED_SPAN) for f in c[2]) for c in calls]
    outs = [sum(c[2]) for c in calls]
    assert len(calls) > 1
    assert max(blocks) <= tr.RAGGED_MAX_BLOCKS
    assert max(outs) <= tr._MAX_CALL_OUT
    for (b, o), nxt in zip(zip(blocks, outs), calls[1:]):
        f = nxt[2][0]  # the next call's first sub-request did not fit
        assert (b + -(-f // tr.RAGGED_SPAN) > tr.RAGGED_MAX_BLOCKS
                or o + f > tr._MAX_CALL_OUT)
    assert [j for c in calls for j, _ in c[0]] == list(range(len(subs)))
    monkeypatch.setattr(tr, "RAGGED_MAX_BLOCKS", 7)
    small = tr._ragged_calls(subs[:20], reqs, {0: 0}, 1)
    assert all(sum(-(-f // tr.RAGGED_SPAN) for f in c[2]) <= 7 or len(c[2]) == 1
               for c in small)


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_reconstruct_intervals_is_one_call_a_burst(coded, monkeypatch, layout):  # noqa: F811
    reqs = _mixed_requests(coded.shape[1])
    cache = _port_cache(coded, missing=(3, 11), layout=layout)
    seen = []
    real = tr._dispatch_call

    def counting(*a, **kw):
        seen.append(len(a[2]))
        return real(*a, **kw)

    monkeypatch.setattr(tr, "_dispatch_call", counting)
    got = tr.reconstruct_intervals(cache, 7, reqs)
    assert seen == [len(tr._plan(reqs))]
    for (sid, off, size), g in zip(reqs, got):
        assert g == coded[sid][off : off + size].tobytes()


# --- the kernel's model, the masks and the ragged plain version ----------------


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_bit_masks_are_the_prepared_bits(layout, w):
    _, a, groups, _ = _prepared(layout, w)
    masks = tr._bit_masks(a, 10, w, groups, w)
    assert masks.shape == (groups * w * 8, 16)
    assert tr._bit_masks(a, 10, w, groups, w) is masks  # kept per system
    m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
    bits = a.numpy()
    table = masks.reshape(groups, w, 8, 16)
    for jg in range(groups):
        for r in range(w):
            for i in range(8):
                for s in range(16):
                    want = 0
                    if s < 10:
                        for j in range(8):
                            want |= int(bits[i * m_pad + jg * w + r,
                                             j * k_pad + jg * 10 + s] != 0) << j
                    assert table[jg, r, i, s] == want, (jg, r, i, s)


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("max_blocks", [tr.RAGGED_MAX_BLOCKS, 5])
def test_launch_model_writes_each_byte_once(survivors, monkeypatch, layout,
                                            max_blocks):
    """The kernel's block -> (request, span) mapping and arithmetic, run in
    numpy over the launches a list splits into, writes each output byte
    exactly once and gives the plain version's bytes."""
    monkeypatch.setattr(tr, "RAGGED_MAX_BLOCKS", max_blocks)
    w = 2
    _, a, groups, unit = _prepared(layout, w)
    rng = np.random.default_rng(max_blocks + groups)
    words, fetches = _ragged_words(rng, 9, w, unit, max_units=5)
    tile = unit
    want, offsets = tr.fused_reconstruct_ragged(
        a, tuple(torch.from_numpy(s) for s in survivors), words, fetches,
        k_true=10, w_true=w, groups=groups)
    launches = tr._launch_lists(tr._work_list(words, fetches, groups, tile))
    assert len(launches) == -(-len(tr._work_list(words, fetches, groups, tile))
                              // max_blocks)
    masks = tr._bit_masks(a, 10, w, groups, w)
    got = np.zeros(want.numel(), dtype=np.uint8)
    writes = np.zeros(want.numel(), dtype=np.int64)
    for base, work in launches:
        assert work.dtype == np.uint32 and len(work) <= max_blocks
        out, n = tr._launch_model(work, masks, survivors, rows=w,
                                  groups=groups, tile=tile,
                                  out_len=want.numel() - base)
        got[base:] |= out
        writes[base:] += n
    assert (writes == 1).all()
    assert np.array_equal(got, want.numpy())
    assert list(offsets) == list(np.cumsum(fetches) - fetches)


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_ragged_plain_equals_uniform_and_oracle(survivors, layout, w):
    mat, a, groups, unit = _prepared(layout, w)
    rng = np.random.default_rng(w + groups)
    words, fetches = _ragged_words(rng, 11, w, unit)
    surv = tuple(torch.from_numpy(s) for s in survivors)
    out, offsets = tr.fused_reconstruct_ragged(
        a, surv, words, fetches, k_true=10, w_true=w, groups=groups)
    assert out.shape == (int(fetches.sum()),)
    out = out.numpy()
    for j, (word, fetch, off) in enumerate(zip(words, fetches, offsets)):
        meta = torch.tensor([word], dtype=torch.int32)
        if groups > 1:
            uni = tr.fused_reconstruct_blockdiag(
                a, surv, meta, tile=unit, fetch=int(fetch), k_true=10,
                w_true=w, groups=groups)
        else:
            uni = tr.fused_reconstruct(a, surv, meta, tile=int(fetch),
                                       fetch=int(fetch), k_true=10, w_true=w)
        piece = out[off : off + fetch]
        assert np.array_equal(piece, uni.numpy()[0]), j
        if j in (0, len(words) - 1):
            assert np.array_equal(piece, _oracle(mat, survivors, word, fetch))


def test_ragged_equals_jax_kernel(survivors):
    """One small case against the JAX kernel: requests of two fetch lengths,
    each group the JAX _fused_reconstruct of that fetch."""
    w = 2
    rng = np.random.default_rng(3)
    words, fetches = _ragged_words(rng, 5, w, 2048, max_units=2)
    a_jax = rs_tpu.prepare_matrix(_system(w))
    out, offsets = tr.fused_reconstruct_ragged(
        rs_cuda.from_jax_prepared(np.asarray(a_jax), "cpu"),
        tuple(torch.from_numpy(s) for s in survivors), words, fetches,
        k_true=10, w_true=w, groups=1)
    for f in np.unique(fetches).tolist():
        idx = np.flatnonzero(fetches == f)
        want = np.asarray(jr._fused_reconstruct(
            a_jax, tuple(jnp.asarray(s) for s in survivors),
            jnp.asarray(words[idx].astype(np.int32)), tile=jr._fused_tile_for(f),
            fetch=f, k_true=10, interpret=True)).reshape(len(idx), f)
        for row, j in zip(want, idx):
            assert np.array_equal(out.numpy()[offsets[j] : offsets[j] + f], row)


def test_ragged_wrapper_refuses_bad_calls(survivors):
    surv = tuple(torch.from_numpy(s) for s in survivors)
    _, a, _, _ = _prepared("flat", 2)
    kw = dict(k_true=10, w_true=2, groups=1)
    last = ((L_SURV - 2048) // 1024 + 1) << tr.META_ROW_BITS
    with pytest.raises(ValueError, match="runs past"):
        tr.fused_reconstruct_ragged(a, surv, [5 << 5, last], [1024, 2048], **kw)
    with pytest.raises(ValueError, match="row"):
        tr.fused_reconstruct_ragged(a, surv, [2], [1024], **kw)
    with pytest.raises(ValueError, match="multiple"):
        tr.fused_reconstruct_ragged(a, surv, [0, 32], [1024, 1500], **kw)
    with pytest.raises(ValueError, match="fetches"):
        tr.fused_reconstruct_ragged(a, surv, [0, 32], [1024], **kw)
    with pytest.raises(ValueError, match="survivors"):
        tr.fused_reconstruct_ragged(a, surv[:9], [0], [1024], **kw)
    _, a_blk, _, _ = _prepared("blockdiag", 2)
    with pytest.raises(ValueError, match="multiple"):  # 4 KiB units for g = 4
        tr.fused_reconstruct_ragged(a_blk, surv, [0], [2048], k_true=10,
                                    w_true=2, groups=GROUPS)
    out, offsets = tr.fused_reconstruct_ragged(a, surv, [], [], **kw)
    assert out.numel() == 0 and len(offsets) == 0

