"""The port's ``linalg``, ``fft``, ``signal`` and ``audio`` held to the JAX
package on the CPU (fp32, inputs from a seed with numpy).

Values are compared within ``RTOL`` / ``ATOL`` (fp32 LAPACK and pocketfft
against XLA's, summed in another order; ``ATOL_SPEC`` for spectra of a
few hundred samples). The factorizations whose factors are fixed only up
to signs or phases, which differ between LAPACK builds (``svd``, ``qr``,
``eig``, ``eigh``, ``pca_lowrank``, ``svd_lowrank``), are held by
reconstruction, orthogonality and their (sorted) spectra instead of
factor by factor, as listed in ``BY_INVARIANTS``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.audio as JAu
import paddle_tpu.fft as JF
import paddle_tpu.linalg as JL
import paddle_tpu.signal as JS
import paddle_tpu_torch.audio as PAu
import paddle_tpu_torch.fft as PF
import paddle_tpu_torch.linalg as PL
import paddle_tpu_torch.signal as PS
from tensor_cases import (FFT_CASES, LINALG_CASES, A, B, BA, R, SPD, T, V,
                          X1, rs)

LINALG, FFT = LINALG_CASES, FFT_CASES
F32 = np.float32

RTOL, ATOL = 1e-4, 1e-5
ATOL_SPEC = 2e-4
# the mel filterbank's weights (at most 0.014 with Slaney's norm, 1
# without) come through float32 exp and log of the mel points, which XLA
# and torch round a few ulps apart
ATOL_FBANK = 2e-5
NARROW = {np.dtype("int64"): np.dtype("int32"),
          np.dtype("float64"): np.dtype("float32"),
          np.dtype("complex128"): np.dtype("complex64")}
BY_INVARIANTS = {"svd": "signs of singular vectors",
                 "qr": "signs of Q's columns and R's rows",
                 "eig": "phases and order of eigenvectors",
                 "eigh": "signs of eigenvectors",
                 "pca_lowrank": "signs of singular vectors",
                 "svd_lowrank": "signs of singular vectors"}


def same(j, p, rtol=RTOL, atol=ATOL):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(p)
        for a, b in zip(j, p):
            same(a, b, rtol, atol)
        return
    a = np.asarray(j)
    b = p.detach().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert NARROW.get(b.dtype, b.dtype) == a.dtype, (a.dtype, b.dtype)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


J, Tt = jnp.asarray, torch.from_numpy


def _j(a):
    if isinstance(a, list):
        return [_j(e) for e in a]
    return J(a.a) if isinstance(a, T) else a


def _p(a):
    if isinstance(a, list):
        return [_p(e) for e in a]
    return Tt(a.a.copy()) if isinstance(a, T) else a


@pytest.mark.parametrize("case", LINALG, ids=[c[0] for c in LINALG])
def test_linalg_function_matches_jax(case):
    cid, args, kw = case
    name = cid.split("-")[0]
    want = getattr(JL, name)(*[_j(a) for a in args],
                             **{k: _j(a) for k, a in kw.items()})
    got = getattr(PL, name)(*[_p(a) for a in args],
                            **{k: _p(a) for k, a in kw.items()})
    if cid == "eigvals-sorted":
        want, got = np.sort_complex(np.asarray(want)), \
            np.sort_complex(got.numpy())
    same(want, got)


def _orthonormal_columns(q, atol=1e-5):
    q = q.detach()
    np.testing.assert_allclose((q.mT.conj() @ q).numpy(),
                               np.eye(q.shape[-1]), atol=atol)


def test_svd_by_reconstruction_and_orthogonality():
    for full in (False, True):
        ju, js, jvh = JL.svd(J(R), full_matrices=full)
        u, s, vh = PL.svd(Tt(R), full_matrices=full)
        assert (u.shape, s.shape, vh.shape) == (ju.shape, js.shape,
                                                jvh.shape)
        same(js, s)
        _orthonormal_columns(u)
        _orthonormal_columns(vh.mT)
        k = s.shape[0]
        np.testing.assert_allclose((u[:, :k] * s @ vh[:k]).numpy(), R,
                                   atol=ATOL * 10)


def test_qr_by_reconstruction():
    for mode in ("reduced", "complete"):
        jq, jr = JL.qr(J(R), mode=mode)
        q, r = PL.qr(Tt(R), mode=mode)
        assert (q.shape, r.shape) == (jq.shape, jr.shape)
        _orthonormal_columns(q)
        assert torch.equal(r, torch.triu(r))
        np.testing.assert_allclose((q @ r).numpy(), R, atol=ATOL * 10)
        np.testing.assert_allclose(np.abs(np.diag(r.numpy())),
                                   np.abs(np.diag(np.asarray(jr))),
                                   rtol=RTOL)
    same(np.abs(np.asarray(JL.qr(J(R), mode="r"))),
         PL.qr(Tt(R), mode="r").abs())


def test_eig_and_eigh_by_reconstruction_and_spectrum():
    jw, _ = JL.eig(J(A))
    w, vecs = PL.eig(Tt(A))
    np.testing.assert_allclose(np.sort_complex(w.numpy()),
                               np.sort_complex(np.asarray(jw)), rtol=RTOL,
                               atol=ATOL)
    a = Tt(A).to(torch.complex64)
    np.testing.assert_allclose((a @ vecs).numpy(), (vecs * w).numpy(),
                               atol=1e-4)
    jw, _ = JL.eigh(J(SPD))
    w, vecs = PL.eigh(Tt(SPD))
    same(jw, w)
    _orthonormal_columns(vecs)
    np.testing.assert_allclose((vecs * w @ vecs.mT).numpy(), SPD, atol=1e-4)


def test_lu_has_one_based_pivots_as_jax_and_unpacks_to_x():
    for a in (A, BA):
        jlu, jpiv = JL.lu(J(a))
        lu, piv = PL.lu(Tt(a))
        same(jlu, lu)
        np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
        assert int(piv.min()) >= 1
        jp, jl, ju = JL.lu_unpack(jlu, jpiv)
        p, l, u = PL.lu_unpack(lu, piv)
        same((jp, jl, ju), (p, l, u))
        np.testing.assert_allclose((p @ l @ u).numpy(), a, atol=1e-5)


def test_lstsq_returns_jax_four_outputs():
    deficient = np.concatenate([R[:, :2], R[:, :1] + R[:, 1:2]], 1)
    for a, b in ((R, B[:, :2].repeat(2, 0)[:5]), (R, V[:5]),
                 (deficient, V[:5]), (A, B)):
        want = JL.lstsq(J(a), J(b))
        got = PL.lstsq(Tt(a), Tt(b))
        same(want, got, atol=1e-4)
    assert int(PL.lstsq(Tt(deficient), Tt(V[:5]))[2]) == 2


def test_householder_product_and_ormqr_from_geqrf():
    a, tau = torch.geqrf(Tt(R))
    want = JL.householder_product(J(a.numpy()), J(tau.numpy()))
    same(want, PL.householder_product(a, tau))
    q = torch.linalg.qr(Tt(R)).Q
    np.testing.assert_allclose(PL.householder_product(a, tau).numpy(),
                               q.numpy(), atol=1e-5)
    y = rs.randn(5, 2).astype(F32)
    for left, tr in ((True, False), (True, True)):
        same(JL.ormqr(J(a.numpy()), J(tau.numpy()), J(y), left, tr),
             PL.ormqr(a, tau, Tt(y), left, tr))
    y2 = rs.randn(2, 5).astype(F32)
    same(JL.ormqr(J(a.numpy()), J(tau.numpy()), J(y2), False, False),
         PL.ormqr(a, tau, Tt(y2), False, False))
    ab, taub = torch.geqrf(Tt(np.stack([R, R * 2])))
    same(JL.householder_product(J(ab.numpy()), J(taub.numpy())),
         PL.householder_product(ab, taub))


@pytest.mark.parametrize("fn", ("pca_lowrank", "svd_lowrank"))
def test_lowrank_on_an_exact_low_rank_input(fn):
    """Rank 2 <= q: the result does not depend on the range finder's
    draw, so the fixed JAX key and the fixed torch generator agree."""
    low = (rs.randn(12, 2) @ rs.randn(2, 7)).astype(F32)
    kw = {"q": 3}
    ju, js, jv = getattr(JL, fn)(J(low), **kw)
    u, s, v = getattr(PL, fn)(Tt(low), **kw)
    np.testing.assert_allclose(s.numpy()[:2], np.asarray(js)[:2], rtol=1e-4)
    assert float(s[2]) < 1e-4 * float(s[0])
    base = low - low.mean(0) if fn == "pca_lowrank" else low
    np.testing.assert_allclose((u * s @ v.mT).numpy(), base, atol=1e-4)
    _orthonormal_columns(u[:, :2])


def test_every_linalg_name_is_held():
    held = {c[0].split("-")[0] for c in LINALG} | set(BY_INVARIANTS) | {
        "lu", "lu_unpack", "lstsq", "householder_product", "ormqr", "eig",
        "eigh"}
    assert set(JL.__all__) - held == set()


# ---------------------------------------------------------------------- fft
@pytest.mark.parametrize("case", FFT, ids=[c[0] for c in FFT])
def test_fft_function_matches_jax(case):
    cid, args, kw = case
    name = cid.split("-")[0]
    want = getattr(JF, name)(*[_j(a) for a in args], **kw)
    got = getattr(PF, name)(*[_p(a) for a in args], **kw)
    same(want, got, atol=ATOL_SPEC)


def test_fft_real_input_gives_complex64_and_freqs_match():
    assert PF.rfft(Tt(X1)).dtype == torch.complex64
    for name in ("fftfreq", "rfftfreq"):
        same(getattr(JF, name)(10, 0.5), getattr(PF, name)(10, 0.5,
                                                           device="cpu"))
    assert set(JF.__all__) - {c[0].split("-")[0] for c in FFT} == \
        {"fftfreq", "rfftfreq"}


# ------------------------------------------------------------------- signal
SIG = rs.randn(2, 300).astype(F32)
WIN = np.hanning(64).astype(F32)


@pytest.mark.parametrize("axis", (-1, 0))
def test_frame_and_overlap_add(axis):
    want = JS.frame(J(SIG), 64, 16, axis=axis)
    got = PS.frame(Tt(SIG), 64, 16, axis=axis)
    same(want, got)
    same(JS.overlap_add(want, 16, axis=axis),
         PS.overlap_add(got, 16, axis=axis))
    with pytest.raises(ValueError):
        PS.frame(Tt(SIG[:, :10]), 64, 16)


@pytest.mark.parametrize("kw", (
    dict(n_fft=64), dict(n_fft=64, hop_length=10, window=WIN),
    dict(n_fft=64, win_length=48, window=WIN[:48], normalized=True),
    dict(n_fft=64, center=False), dict(n_fft=64, onesided=False),
    dict(n_fft=64, pad_mode="constant")),
    ids=("default", "window", "short-window-normalized", "no-center",
         "twosided", "constant-pad"))
def test_stft_and_istft_match_jax(kw):
    jkw = {k: (J(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (Tt(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = JS.stft(J(SIG), **jkw)
    got = PS.stft(Tt(SIG), **pkw)
    same(want, got, atol=ATOL_SPEC)
    ikw = {k: v for k, v in jkw.items() if k != "pad_mode"}
    pikw = {k: v for k, v in pkw.items() if k != "pad_mode"}
    same(JS.istft(want, **ikw), PS.istft(got, **pikw), atol=ATOL_SPEC)


def test_stft_of_a_signal_shorter_than_the_reflect_pad():
    """numpy's reflect reflects again past the signal: a [2, 40] signal
    takes n_fft 128 (torch's reflect pad refuses it), and istft's
    ``length=40`` truncates to the 32 samples there are, never pads."""
    s = rs.randn(2, 40).astype(F32)
    want = JS.stft(J(s), n_fft=128, hop_length=16)
    got = PS.stft(Tt(s), n_fft=128, hop_length=16)
    assert tuple(got.shape) == (2, 65, 3)
    same(want, got, atol=ATOL_SPEC)
    wi = JS.istft(want, n_fft=128, hop_length=16, length=40)
    gi = PS.istft(got, n_fft=128, hop_length=16, length=40)
    assert gi.shape[-1] == 32
    same(wi, gi, atol=ATOL_SPEC)
    with pytest.raises(RuntimeError):
        torch.nn.functional.pad(Tt(s)[:, None], (64, 64), mode="reflect")


def test_istft_return_complex_needs_two_sided():
    spec = PS.stft(Tt(SIG), 64)
    with pytest.raises(ValueError):
        PS.istft(spec, 64, return_complex=True)
    want = JS.istft(JS.stft(J(SIG), 64, onesided=False), 64,
                    onesided=False, return_complex=True)
    got = PS.istft(PS.stft(Tt(SIG), 64, onesided=False), 64,
                   onesided=False, return_complex=True)
    same(want, got, atol=ATOL_SPEC)


# -------------------------------------------------------------------- audio
@pytest.mark.parametrize("window", ("hann", "hamming", "blackman", "ones"))
@pytest.mark.parametrize("fftbins", (True, False))
def test_get_window(window, fftbins):
    same(JAu.get_window(window, 32, fftbins),
         PAu.get_window(window, 32, fftbins, device="cpu"))


@pytest.mark.parametrize("htk", (False, True))
def test_mel_scale_and_filterbank(htk):
    f = np.array([0., 300., 1000., 4000., 8000.], F32)
    same(JAu.hz_to_mel(J(f), htk), PAu.hz_to_mel(Tt(f), htk))
    same(JAu.mel_to_hz(JAu.hz_to_mel(J(f), htk), htk),
         PAu.mel_to_hz(PAu.hz_to_mel(Tt(f), htk), htk))
    same(JAu.mel_frequencies(10, 20.0, 8000.0, htk),
         PAu.mel_frequencies(10, 20.0, 8000.0, htk, device="cpu"))
    for norm in ("slaney", None):
        same(JAu.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk,
                                      norm),
             PAu.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk, norm,
                                      device="cpu"), atol=ATOL_FBANK)


def test_dct_and_power_to_db():
    for norm in ("ortho", None):
        same(JAu.create_dct(13, 40, norm),
             PAu.create_dct(13, 40, norm, device="cpu"))
    p = np.abs(rs.randn(2, 40, 9)).astype(F32) ** 4
    for top_db in (80.0, None, 10.0):
        same(JAu.power_to_db(J(p), 2.0, 1e-10, top_db),
             PAu.power_to_db(Tt(p), 2.0, 1e-10, top_db))


@pytest.mark.parametrize("layer", ("Spectrogram", "MelSpectrogram",
                                   "LogMelSpectrogram", "MFCC"))
def test_feature_layers(layer):
    wave = rs.randn(2, 4000).astype(F32)
    kw = {"Spectrogram": dict(n_fft=256),
          "MelSpectrogram": dict(sr=16000, n_fft=256, n_mels=32),
          "LogMelSpectrogram": dict(sr=16000, n_fft=256, n_mels=32,
                                    top_db=80.0),
          "MFCC": dict(sr=16000, n_mfcc=13, n_mels=32, n_fft=256)}[layer]
    want = getattr(JAu, layer)(**kw)(J(wave))
    got = getattr(PAu, layer)(**kw, device="cpu")(Tt(wave))
    scale = float(np.abs(np.asarray(want)).max())
    same(want, got, rtol=1e-4, atol=1e-5 * scale)
