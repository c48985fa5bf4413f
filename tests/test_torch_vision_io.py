"""The port's ``vision.transforms`` and ``vision.datasets`` against the JAX
package's: host numpy code, so every output must be equal bit for bit.

- every transform on uint8 and float HWC images, the random ones with
  ``np.random.default_rng(seed)`` on both sides;
- ``FakeData`` (``RandomState(seed + idx)``), ``MNIST`` and
  ``FashionMNIST`` on IDX files, plain and gzip, ``Cifar10`` and
  ``Cifar100`` on pickled batches, ``DatasetFolder`` and ``ImageFolder``
  on ``.npy`` trees, all written by the test itself;
- ``download=True`` raises the no-egress error, and an encoded image
  with no PIL raises ``RuntimeError``, as in the JAX package;
- ``vision`` re-exports the port's models.
"""
import gzip
import os
import pickle
import struct
import sys

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _images():
    rs = np.random.RandomState(0)
    return {"uint8": rs.randint(0, 256, (37, 45, 3)).astype(np.uint8),
            "float": rs.rand(40, 33, 3).astype(np.float32),
            "gray": rs.randint(0, 256, (20, 30)).astype(np.uint8)}


def _pipeline(T, seed):
    return T.Compose([
        T.RandomResizedCrop(24, rng=np.random.default_rng(seed)),
        T.RandomHorizontalFlip(rng=np.random.default_rng(seed + 1)),
        T.ToTensor(), T.Normalize(MEAN, STD)])


TRANSFORMS = {
    "resize_bilinear": lambda T, s: T.Resize((17, 29)),
    "resize_nearest": lambda T, s: T.Resize(23, interpolation="nearest"),
    "center_crop": lambda T, s: T.CenterCrop(16),
    "center_crop_pad": lambda T, s: T.CenterCrop((50, 20),
                                                 pad_if_needed=True),
    "random_crop": lambda T, s: T.RandomCrop(
        (12, 15), rng=np.random.default_rng(s)),
    "random_crop_pad": lambda T, s: T.RandomCrop(
        48, pad_if_needed=True, rng=np.random.default_rng(s)),
    "hflip": lambda T, s: T.RandomHorizontalFlip(
        prob=0.5, rng=np.random.default_rng(s)),
    "random_resized_crop": lambda T, s: T.RandomResizedCrop(
        (20, 18), scale=(0.3, 1.0), rng=np.random.default_rng(s)),
    "to_tensor": lambda T, s: T.ToTensor(),
    "normalize_hwc": lambda T, s: T.Normalize(MEAN, STD, data_format="HWC"),
    "transpose": lambda T, s: T.Transpose((2, 0, 1)),
    "imagenet_train": lambda T, s: _pipeline(T, s),
}


def test_every_jax_transform_and_dataset_is_ported():
    for jmod, tmod in ((jT, tT), (jds, tds)):
        names = [n for n, v in vars(jmod).items() if not n.startswith("_")
                 and callable(v) and getattr(v, "__module__", "") ==
                 jmod.__name__]
        assert names and [n for n in names if not hasattr(tmod, n)] == []


@pytest.mark.parametrize("name", tuple(TRANSFORMS))
@pytest.mark.parametrize("kind", ("uint8", "float", "gray"))
def test_transform_bit_for_bit_as_jax(name, kind):
    img = _images()[kind]
    if kind == "gray" and name in ("normalize_hwc", "transpose",
                                   "imagenet_train"):
        img = img[:, :, None]
    jt, tt = TRANSFORMS[name](jT, 5), TRANSFORMS[name](tT, 5)
    for _ in range(4):   # the random ones move on as the JAX ones do
        want, got = jt(img.copy()), tt(img.copy())
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_crop_smaller_than_the_image_raises_as_jax():
    img = _images()["uint8"]
    for T in (jT, tT):
        with pytest.raises(ValueError, match="pad_if_needed"):
            T.RandomCrop(64)(img)


def test_fake_data_as_jax():
    for kw in (dict(num_samples=5, image_shape=(3, 8, 8), num_classes=7),
               dict(num_samples=4, image_shape=(16, 16, 3), seed=3,
                    transform="pipeline")):
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("transform"):
            jkw["transform"] = _pipeline(jT, 1)
            tkw["transform"] = _pipeline(tT, 1)
        jd, td = jds.FakeData(**jkw), tds.FakeData(**tkw)
        assert len(td) == len(jd)
        for i in range(len(jd)):
            (ji, jl), (ti, tl) = jd[i], td[i]
            np.testing.assert_array_equal(ti, ji)
            assert tl == jl and type(tl) is type(jl)
        with pytest.raises(IndexError):
            td[len(td)]


def _write_idx(path, arr):
    magic = 0x0800 | arr.ndim
    data = struct.pack(">I", magic) + struct.pack(f">{arr.ndim}I",
                                                  *arr.shape)
    data += arr.astype(np.uint8).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("cls", ("MNIST", "FashionMNIST"))
@pytest.mark.parametrize("gz", (False, True))
def test_mnist_family_on_idx_files_as_jax(tmp_path, cls, gz):
    rs = np.random.RandomState(1)
    ext = ".gz" if gz else ""
    for mode, n in (("train", 6), ("test", 3)):
        img_name, lab_name = jds.MNIST._FILES[mode]
        _write_idx(str(tmp_path / (img_name + ext)),
                   rs.randint(0, 256, (n, 28, 28)))
        _write_idx(str(tmp_path / (lab_name + ext)), rs.randint(0, 10, n))
    for mode in ("train", "test"):
        jd = getattr(jds, cls)(str(tmp_path), mode=mode)
        td = getattr(tds, cls)(str(tmp_path), mode=mode,
                               transform=tT.Normalize([0.5], [0.5], "HWC"))
        jd.transform = jT.Normalize([0.5], [0.5], "HWC")
        assert len(td) == len(jd)
        for i in range(len(jd)):
            np.testing.assert_array_equal(td[i][0], jd[i][0])
            assert td[i][1] == jd[i][1]


def _write_cifar(root, subdir, names, label_key, rs):
    d = os.path.join(root, subdir)
    os.makedirs(d)
    for name in names:
        batch = {b"data": rs.randint(0, 256, (4, 3 * 32 * 32)).astype(
            np.uint8), label_key: list(rs.randint(0, 10, 4))}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("cls", ("Cifar10", "Cifar100"))
def test_cifar_on_pickled_batches_as_jax(tmp_path, cls):
    rs = np.random.RandomState(2)
    jcls = getattr(jds, cls)
    _write_cifar(str(tmp_path), jcls._SUBDIR, jcls._TRAIN + jcls._TEST,
                 jcls._LABEL_KEY, rs)
    for mode in ("train", "test"):
        jd = jcls(str(tmp_path), mode=mode)
        td = getattr(tds, cls)(str(tmp_path), mode=mode)
        assert len(td) == len(jd) > 0
        for i in (0, len(jd) - 1):
            np.testing.assert_array_equal(td[i][0], jd[i][0])
            assert td[i][1] == jd[i][1]
    with pytest.raises(ValueError, match="mode"):
        getattr(tds, cls)(str(tmp_path), mode="val")


def test_dataset_and_image_folders_on_npy_trees_as_jax(tmp_path):
    rs = np.random.RandomState(3)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / "tree" / c)
        for i in range(3):
            np.save(tmp_path / "tree" / c / f"{i}.npy",
                    rs.rand(6, 5, 3).astype(np.float32))
    (tmp_path / "tree" / "dog" / "notes.txt").write_text("skip me")
    os.makedirs(tmp_path / "flat")
    for i in range(2):
        np.save(tmp_path / "flat" / f"{i}.npy", rs.rand(4, 4, 3))
    jd = jds.DatasetFolder(str(tmp_path / "tree"))
    td = tds.DatasetFolder(str(tmp_path / "tree"),
                           transform=tT.ToTensor())
    assert td.classes == jd.classes and td.class_to_idx == jd.class_to_idx
    assert [s[1] for s in td.samples] == [s[1] for s in jd.samples]
    jd.transform = jT.ToTensor()
    for i in range(len(jd)):
        np.testing.assert_array_equal(td[i][0], jd[i][0])
        assert td[i][1] == jd[i][1]
    jf, tf = (jds.ImageFolder(str(tmp_path / "flat")),
              tds.ImageFolder(str(tmp_path / "flat")))
    assert len(tf) == len(jf) == 2
    np.testing.assert_array_equal(tf[1][0], jf[1][0])
    assert len(tf[0]) == 1
    with pytest.raises(FileNotFoundError):
        tds.DatasetFolder(str(tmp_path / "flat"))


def test_download_and_missing_files_raise_as_jax(tmp_path):
    for mod in (jds, tds):
        for cls in (mod.MNIST, mod.FashionMNIST, mod.Cifar10, mod.Cifar100):
            with pytest.raises(RuntimeError, match="no network egress"):
                cls(str(tmp_path), download=True)
        with pytest.raises(FileNotFoundError, match="no network egress"):
            mod.MNIST(str(tmp_path))


def test_an_encoded_image_without_pil_raises(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "a")
    (tmp_path / "a" / "x.png").write_bytes(b"\x89PNG not really")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for mod in (jds, tds):
        with pytest.raises(RuntimeError, match="PIL"):
            mod.DatasetFolder(str(tmp_path))[0]


def test_vision_reexports_the_port_models():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet, vit
    assert ptt.vision.resnet50 is resnet.resnet50
    assert ptt.vision.ViTForImageClassification is \
        vit.ViTForImageClassification
    for name in ("ResNet", "resnet18", "resnet34", "resnet50_vd"):
        assert hasattr(ptt.vision, name)
