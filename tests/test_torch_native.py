"""The port's host runtime (``paddle_tpu_torch/native``) against the JAX
package's ``paddle_tpu.native`` on the same inputs: the staging arena,
``gather_stack``, ``gather_pad``, the ring and the trie tokenizer give the
same outputs (exactly: they move bytes and ints), and
``DataLoader(use_native=True)`` gives the JAX loader's batches, with the
native loader's counter saying which way each batch went. A build with a
broken ``$CXX`` raises with the compiler's output, and no native path
gives way to Python."""
import threading

import numpy as np
import pytest

import paddle_tpu.io as jio
import paddle_tpu.native as jnative
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import native
from paddle_tpu_torch.native import loader as native_loader


@pytest.fixture(scope="module")
def pools():
    assert jnative.available(), "the JAX package's native runtime is built"
    assert native.available()
    return jnative.ThreadPool(3), native.ThreadPool(3)


def test_library_is_built_into_the_build_dir_by_hash():
    path = native._target(native.compiler())
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libpaddle_tpu_torch_native-")
    assert native.lib() is native.lib()


def test_arena_alignment_use_and_reset_as_jax():
    ja, pa = jnative.StagingArena(1 << 16), native.StagingArena(1 << 16)
    for nbytes in (100, 3000, 64):
        jv = ja.alloc(nbytes, np.uint8, (nbytes,))
        pv = pa.alloc(nbytes, np.uint8, (nbytes,))
        assert pv.ctypes.data % 64 == jv.ctypes.data % 64
        assert pa.used() == ja.used()
    pv[:] = 7
    assert (pv == 7).all()
    pa.reset()
    ja.reset()
    assert pa.used() == ja.used() == 0
    with pytest.raises(MemoryError):
        pa.alloc(1 << 17, np.uint8, (1 << 17,))


@pytest.mark.parametrize("dtype", (np.float32, np.int64, np.uint8))
def test_gather_stack_matches_jax(pools, dtype):
    jp, pp = pools
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal((5, 7)) * 100).astype(dtype)
             for _ in range(9)]
    want = jnative.gather_stack(jp, items)
    got = native.gather_stack(pp, items)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(items))
    arena = native.StagingArena(1 << 20)
    np.testing.assert_array_equal(native.gather_stack(pp, items, arena),
                                  want)
    assert arena.used() >= want.nbytes
    with pytest.raises(ValueError, match="same-shape"):
        native.gather_stack(pp, [items[0], items[1][:2]])


@pytest.mark.parametrize("max_len,pad", ((8, 0), (5, -1), (3, 9)))
def test_gather_pad_matches_jax(pools, max_len, pad):
    jp, pp = pools
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 1000, n) for n in (0, 1, 4, 7, 3)]
    for dtype in (np.int32, np.int64):
        want = jnative.gather_pad(jp, seqs, max_len, pad, dtype)
        got = native.gather_pad(pp, seqs, max_len, pad, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ring_matches_jax_and_hands_off_across_threads():
    for ring_cls in (jnative.Ring, native.Ring):
        r = ring_cls(4)
        assert [r.push(v, 0) for v in (3, 1, 2)] == [True] * 3
        assert len(r) == 3 and [r.pop(0) for _ in range(3)] == [3, 1, 2]
        with pytest.raises(TimeoutError):
            r.pop(10)
    r = native.Ring(2)
    got = []

    def consume():
        while (v := r.pop(2000)) is not None:
            got.append(v)

    t = threading.Thread(target=consume)
    t.start()
    for v in range(50):
        r.push(v, 2000)
    r.close()
    t.join(10)
    assert not t.is_alive() and got == list(range(50))


def test_trie_tokenizer_matches_jax(pools):
    jp, pp = pools
    vocab = ["<unk>", "a", "ab", "abc", "b", "c", " ", "ca", "é", "漢字"]
    texts = ["abcab c", "", "cacab", "zzab", "é漢字abé", "abc" * 40]
    jt, pt = jnative.Tokenizer(vocab, 0), native.Tokenizer(vocab, 0)
    assert pt.vocab_size == jt.vocab_size
    for text in texts:
        np.testing.assert_array_equal(pt.encode(text), jt.encode(text))
    for max_len in (4, 16):
        want = jt.encode_batch(texts, jp, max_len=max_len, pad_id=-1)
        got = pt.encode_batch(texts, pp, max_len=max_len, pad_id=-1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _datasets(lib):
    rng = np.random.default_rng(2)
    images = rng.standard_normal((10, 3, 32, 32)).astype(np.float32)
    masks = rng.integers(0, 9, (10, 1024)).astype(np.int64)
    return {
        "images": lib.TensorDataset([images]),               # native
        "pairs": lib.TensorDataset([images, masks]),         # native
        "labelled": lib.TensorDataset([images, np.arange(10)]),  # collate
        "small": lib.TensorDataset([images[:, :, :2, :2]]),  # collate
    }


@pytest.mark.parametrize("num_workers", (0, 2))
@pytest.mark.parametrize("kind,native_batches",
                         (("images", 4), ("pairs", 4), ("labelled", 0),
                          ("small", 0)))
def test_native_dataloader_matches_jax(kind, native_batches, num_workers):
    jds, pds = _datasets(jio)[kind], _datasets(tio)[kind]
    kw = dict(batch_size=3, shuffle=False, use_native=True,
              num_workers=num_workers)
    want = [[np.asarray(c) for c in b] for b in jio.DataLoader(jds, **kw)]
    before = dict(native_loader.counts)
    loader = tio.DataLoader(pds, **kw)
    got = [[np.asarray(c) for c in b] for b in loader]
    assert loader._pool is None          # a native loader spawns no worker
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    ran = {k: native_loader.counts[k] - before[k] for k in before}
    assert ran == {"native": native_batches, "collate": 4 - native_batches}


def test_broken_compiler_raises_and_nothing_gives_way(monkeypatch):
    from paddle_tpu_torch.tokenizer import BPETokenizer
    monkeypatch.setenv("CXX", "g++ -DPT_BROKEN_BUILD -x c++-nonexistent")
    with pytest.raises(RuntimeError, match="native runtime build failed") \
            as err:
        native.lib()
    assert "c++-nonexistent" in str(err.value)   # the compiler's own words
    with pytest.raises(RuntimeError, match="build failed"):
        native.available()
    with pytest.raises(RuntimeError, match="build failed"):
        native.ThreadPool(1)
    # a fresh thread state, as in a new process (a pool this thread built
    # before the compiler broke holds the library already loaded)
    monkeypatch.setattr(native_loader, "_state", threading.local())
    before = dict(native_loader.counts)
    with pytest.raises(RuntimeError, match="build failed"):
        list(tio.DataLoader(_datasets(tio)["images"], batch_size=3,
                            use_native=True))
    assert native_loader.counts == before
    with pytest.raises(RuntimeError, match="build failed"):
        BPETokenizer({"a": 0, "b": 1, "ab": 2}, [("a", "b")])
    monkeypatch.setenv("CXX", "/nonexistent/bin/c++")
    with pytest.raises(RuntimeError, match="build failed"):
        native.lib()
