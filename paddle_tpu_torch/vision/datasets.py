"""paddle.vision.datasets (the port's copy of
``paddle_tpu/vision/datasets.py``; reference:
python/paddle/vision/datasets: MNIST, FashionMNIST, Cifar10, Cifar100,
DatasetFolder, ImageFolder and the synthetic FakeData).

There is no network: ``download=True`` raises, and the loaders read the
standard on-disk formats the user provides (IDX, plain or gzip, for the
MNIST family; the pickled batches for CIFAR; a directory a class, of
``.npy`` arrays or, where PIL is installed, encoded images, for
DatasetFolder). ``FakeData`` draws each sample from
``RandomState(seed + idx)``, so workers and shards see the same data
without materialising it. Samples are numpy, as in the JAX package.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..io.dataset import Dataset

__all__ = ["FakeData", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder"]

_NO_EGRESS = ("this environment has no network egress; place the dataset "
              "files at {path} and pass download=False")


class FakeData(Dataset):
    """Deterministic synthetic image dataset (reference:
    paddle.vision.datasets.FakeData): seeded per-index generation, so
    workers/shards see consistent data without materializing it."""

    def __init__(self, num_samples: int = 1000,
                 image_shape: Sequence[int] = (3, 224, 224),
                 num_classes: int = 10, seed: int = 0,
                 transform: Optional[Callable] = None):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.seed = seed
        self.transform = transform

    def __getitem__(self, idx):
        if not 0 <= idx < self.num_samples:
            raise IndexError(idx)
        rs = np.random.RandomState(self.seed + idx)
        img = rs.rand(*self.image_shape).astype(np.float32)
        label = rs.randint(0, self.num_classes)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return self.num_samples


def _read_idx(path: str) -> np.ndarray:
    """IDX (MNIST) format reader; transparently handles .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


class MNIST(Dataset):
    """Reference: paddle.vision.datasets.MNIST. Expects the standard IDX
    files under ``root`` (train-images-idx3-ubyte[.gz], ...)."""

    _FILES = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root: str, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2"):
        if download:
            raise RuntimeError(_NO_EGRESS.format(path=root))
        img_name, lab_name = self._FILES[mode]
        self.images = _read_idx(_find(root, img_name))
        self.labels = _read_idx(_find(root, lab_name))
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """Same IDX format, different files (reference: FashionMNIST)."""


def _find(root: str, base: str) -> str:
    for cand in (base, base + ".gz"):
        p = os.path.join(root, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(_NO_EGRESS.format(path=os.path.join(root, base)))


class Cifar10(Dataset):
    """Reference: paddle.vision.datasets.Cifar10 — reads the
    ``cifar-10-batches-py`` pickle batches under ``root``."""

    _TRAIN = [f"data_batch_{i}" for i in range(1, 6)]
    _TEST = ["test_batch"]
    _SUBDIR = "cifar-10-batches-py"
    _LABEL_KEY = b"labels"

    def __init__(self, root: str, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2"):
        if download:
            raise RuntimeError(_NO_EGRESS.format(path=root))
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        base = os.path.join(root, self._SUBDIR)
        if not os.path.isdir(base):
            base = root
        names = self._TRAIN if mode == "train" else self._TEST
        imgs, labels = [], []
        for n in names:
            p = os.path.join(base, n)
            if not os.path.exists(p):
                raise FileNotFoundError(_NO_EGRESS.format(path=p))
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(d[b"data"].reshape(-1, 3, 32, 32))
            labels.extend(d[self._LABEL_KEY])
        self.images = np.concatenate(imgs)
        self.labels = np.asarray(labels, np.int64)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    _TRAIN = ["train"]
    _TEST = ["test"]
    _SUBDIR = "cifar-100-python"
    _LABEL_KEY = b"fine_labels"


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path), np.float32) / 255.0
    except ImportError as e:
        raise RuntimeError("loading encoded images needs PIL; store .npy "
                           "arrays instead") from e


class DatasetFolder(Dataset):
    """class-per-subdirectory tree (reference:
    paddle.vision.datasets.DatasetFolder)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 extensions: Sequence[str] = _IMG_EXTS):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.transform = transform
        self.loader = loader or _load_image

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Flat (unlabeled) image folder (reference: ImageFolder)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 extensions: Sequence[str] = _IMG_EXTS):
        self.samples = [(os.path.join(root, f), -1)
                        for f in sorted(os.listdir(root))
                        if f.lower().endswith(tuple(extensions))]
        self.classes, self.class_to_idx = [], {}
        self.transform = transform
        self.loader = loader or _load_image

    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return (img,)
