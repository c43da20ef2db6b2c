"""MNIST: ``MnistDataSetIterator``.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``. IDX files
(``train-images-idx3-ubyte``, ... plain or ``.gz``) are read with numpy from
``$MNIST_DIR`` or ``~/.cache/mnist`` when they are there; nothing is ever
downloaded. Without them the iterator serves the JAX package's deterministic
synthetic digits (the same generator and seeds, 123 for training and 321
for testing), so both packages give the same arrays.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .iterators import ArrayDataSetIterator

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def search_dirs() -> List[str]:
    """Where IDX files are looked for, read at call time."""
    return [d for d in (os.environ.get("MNIST_DIR", ""),
                        str(Path.home() / ".cache" / "mnist")) if d]


def read_idx(path: Path) -> np.ndarray:
    """An IDX file as a uint8 array: a big-endian magic whose low byte is
    the rank, the dims, then the data."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">i", f.read(4))[0]
        dims = [struct.unpack(">i", f.read(4))[0] for _ in range(magic & 0xFF)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_real_mnist(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    img_name, lbl_name = _FILES[train]
    for d in search_dirs():
        for suffix in ("", ".gz"):
            img = Path(d) / (img_name + suffix)
            lbl = Path(d) / (lbl_name + suffix)
            if img.exists() and lbl.exists():
                return read_idx(img), read_idx(lbl)
    return None


def synthetic_mnist(n: int, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` digit-like uint8 images ``[n, 28, 28]`` and labels: each class
    a fixed template of 4 strokes, shifted by up to 2 pixels and noised.
    The JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    templates = np.zeros((10, 28, 28), np.float32)
    for d in range(10):
        trng = np.random.default_rng(1000 + d)
        for _ in range(4):
            r0, c0 = trng.integers(4, 24, 2)
            dr, dc = trng.integers(-3, 4, 2)
            for t in range(12):
                r = int(np.clip(r0 + dr * t / 4, 0, 27))
                c = int(np.clip(c0 + dc * t / 4, 0, 27))
                templates[d, r, c] = 1.0
                if r + 1 < 28:
                    templates[d, r + 1, c] = max(templates[d, r + 1, c], 0.6)
                if c + 1 < 28:
                    templates[d, r, c + 1] = max(templates[d, r, c + 1], 0.6)
    labels = rng.integers(0, 10, n)
    imgs = templates[labels]
    shifted = np.empty_like(imgs)
    for i in range(n):
        sr, sc = rng.integers(-2, 3, 2)
        shifted[i] = np.roll(np.roll(imgs[i], sr, axis=0), sc, axis=1)
    noisy = np.clip(shifted + rng.normal(0, 0.15, shifted.shape), 0, 1)
    return (noisy * 255).astype(np.uint8), labels.astype(np.uint8)


class MnistDataSetIterator(ArrayDataSetIterator):
    """Features ``[B, 784]`` float32 in [0, 1] (``[B, 28, 28, 1]`` with
    ``flatten=False``) and one-hot labels ``[B, 10]``. ``synthetic`` says
    whether the synthetic digits stand in for the IDX files."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 6, num_examples: Optional[int] = None,
                 flatten: bool = True):
        real = _find_real_mnist(train)
        if real is not None:
            images, labels = real
            self.synthetic = False
        else:
            n = num_examples or (60000 if train else 10000)
            images, labels = synthetic_mnist(n, seed=123 if train else 321)
            self.synthetic = True
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        feats = images.astype(np.float32) / 255.0
        feats = feats.reshape(len(feats), -1) if flatten else feats[..., None]
        onehot = np.zeros((len(labels), 10), np.float32)
        onehot[np.arange(len(labels)), labels] = 1.0
        super().__init__(feats, onehot, batch, shuffle=shuffle, seed=seed)
