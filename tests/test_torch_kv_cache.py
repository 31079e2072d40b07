"""Port parity: serving/kv_cache.py.

Page ids feed identical token streams, so the port's allocator must hand
out pages in the JAX allocator's order through any sequence of allocs
and releases, and `SequencePages` must build the same table rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import kv_cache as jkv
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import kv_cache as tkv


def _script(alloc_cls, seq_cls):
    """A fixed alloc/grow/release script; returns everything observable."""
    alloc = alloc_cls(20)
    seqs = [seq_cls(alloc, 8, 6) for _ in range(3)]
    out = []
    for step, (i, n) in enumerate([(0, 5), (1, 17), (2, 9), (0, 30), (1, 0),
                                   (2, 40), (1, 12), (0, 0), (0, 3)]):
        if n == 0:
            seqs[i].release()
        else:
            seqs[i].ensure(n)
        out.append((step, alloc.n_free, [s.table_row().tolist()
                                         for s in seqs],
                    [s.length for s in seqs]))
    return out


def test_allocator_and_sequence_rows_match_jax():
    assert _script(tkv.PageAllocator, tkv.SequencePages) == _script(
        jkv.PageAllocator, jkv.SequencePages)


def test_refcounts_and_errors_match_jax():
    for mod in (tkv, jkv):
        a = mod.PageAllocator(4)
        pages = a.alloc(2)
        assert pages == [1, 2]
        a.retain([1])
        a.release([1, 2])
        assert a.refcount(1) == 1 and a.refcount(2) == 0
        with pytest.raises(ValueError, match="double free"):
            a.release([2])
        with pytest.raises(ValueError, match="out of range"):
            a.release([0])
        with pytest.raises(MemoryError):
            a.alloc(5)


def test_sequence_over_max_pages_raises_like_jax():
    for mod in (tkv, jkv):
        seq = mod.SequencePages(mod.PageAllocator(32), 8, 2)
        with pytest.raises(MemoryError, match="max_pages"):
            seq.ensure(17)


def test_page_pool_layout_matches_jax():
    jp = jkv.PagePool.zeros(jl.LlamaConfig.tiny(), 9, 8, dtype=jnp.float32)
    tp = tkv.PagePool.zeros(tl.LlamaConfig.tiny(), 9, 8, dtype=torch.float32,
                            device="cpu")
    assert tuple(tp.k.shape) == tuple(jp.k.shape)
    assert tuple(tp.v.shape) == tuple(jp.v.shape)
    assert (tp.n_pages, tp.page_size) == (jp.n_pages, jp.page_size)
    assert not np.any(tp.k.numpy())


def test_int8_pool_is_not_ported_yet():
    """Kept under its first name: the int8 pool was this module's unported
    part and is ported now. dtype int8 gives the fused QuantPagePool, in
    the JAX package's layout and dtypes, zeroed."""
    pool = tkv.PagePool.zeros(tl.LlamaConfig.tiny(), 4, 8, dtype=torch.int8,
                              device="cpu")
    want = jkv.QuantPagePool.zeros(jl.LlamaConfig.tiny(), 4, 8)
    assert isinstance(pool, tkv.QuantPagePool) and pool.quantized
    assert pool.kv.shape == want.kv.shape and pool.s.shape == want.s.shape
    assert str(pool.kv.dtype).endswith(str(want.kv.dtype))
    assert str(pool.s.dtype).endswith(str(want.s.dtype))
    assert pool.n_pages == want.n_pages and pool.page_size == 8
    assert not pool.kv.any() and not pool.s.any()
