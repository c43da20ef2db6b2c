"""Dataset fetchers: CIFAR-10, LFW, Curves and Iris.

Counterpart of ``deeplearning4j_tpu/datasets/fetchers.py`` (and of the JAX
package's Iris iterator in ``datasets/mnist.py``). Nothing is downloaded.
Real data is read where it lies locally: CIFAR-10 binaries
(``data_batch_*.bin``, ``test_batch.bin``) from ``$CIFAR_DIR`` or
``~/.cache/cifar10``, and LFW (a directory of per-person directories of
images, read with Pillow) from ``$LFW_DIR`` or ``~/.cache/lfw``. Without
them each iterator serves the JAX package's deterministic synthetic data:
the same generators, seeds and dtypes, so both packages give the same
arrays. Curves and Iris are always synthetic. ``synthetic`` tells which.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .iterators import ArrayDataSetIterator

_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def _search_dirs(env: str, cache_name: str) -> List[str]:
    """Where local files are looked for, read at call time."""
    return [d for d in (os.environ.get(env, ""),
                        str(Path.home() / ".cache" / cache_name)) if d]


def _find_cifar_files(train: bool) -> Optional[List[Path]]:
    for d in _search_dirs("CIFAR_DIR", "cifar10"):
        base = Path(d)
        if not base.is_dir():
            continue
        files = sorted(base.glob("data_batch_*.bin" if train
                                 else "test_batch.bin"))
        if files:
            return files
    return None


def _parse_cifar(files: List[Path]) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records: a label byte, then 3072 channel-major
    pixel bytes."""
    recs = np.concatenate([np.frombuffer(p.read_bytes(), np.uint8)
                           .reshape(-1, 3073) for p in files])
    return recs[:, 1:], recs[:, 0]


def _synthetic_cifar(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent colour and texture patches (learnable,
    deterministic): ``[n, 3072]`` uint8 HWC pixels and uint8 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    base_hue = np.linspace(0, 1, 10, endpoint=False)
    imgs = np.empty((n, 32, 32, 3), np.float32)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    for i, c in enumerate(labels):
        freq = 1 + (c % 5)
        pattern = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx * np.cos(base_hue[c] * np.pi)
                                + yy * np.sin(base_hue[c] * np.pi)))
        rgb = np.stack([pattern * (0.3 + 0.7 * base_hue[c]),
                        pattern * (1.0 - base_hue[c]),
                        1.0 - pattern], axis=-1)
        imgs[i] = np.clip(rgb + rng.normal(0, 0.08, rgb.shape), 0, 1)
    return (imgs * 255).astype(np.uint8).reshape(n, -1), labels.astype(np.uint8)


def _one_hot(labels, n: int) -> np.ndarray:
    y = np.zeros((len(labels), n), np.float32)
    y[np.arange(len(labels)), labels] = 1.0
    return y


class CifarDataSetIterator(ArrayDataSetIterator):
    """CIFAR-10: NHWC ``[B, 32, 32, 3]`` float32 in [0, 1] (``[B, 3072]``
    with ``flatten``) and one-hot labels of 10 classes."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 12, num_examples: Optional[int] = None,
                 flatten: bool = False):
        files = _find_cifar_files(train)
        self.synthetic = files is None
        if files is not None:
            feats, labels = _parse_cifar(files)
        else:
            feats, labels = _synthetic_cifar(
                num_examples or (50000 if train else 10000), 7 if train else 8)
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        x = feats.astype(np.float32) / 255.0
        # NHWC before any flattening: the binaries are channel-major, the
        # synthetic pixels HWC
        if self.synthetic:
            x = x.reshape(-1, 32, 32, 3)
        else:
            x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        if flatten:
            x = x.reshape(len(x), -1)
        super().__init__(x, _one_hot(labels, 10), batch, shuffle=shuffle,
                         seed=seed)


def _find_lfw_dir() -> Optional[Path]:
    for d in _search_dirs("LFW_DIR", "lfw"):
        p = Path(d)
        if p.is_dir() and any(p.iterdir()):
            return p
    return None


def _read_image_dir(root: Path, size: int, limit: int):
    """Greyscale ``[n, size, size, 1]`` images in [0, 1] and their labels:
    the index of each file's directory name among the sorted names (the
    JAX package's ``ImageRecordReader`` order), at most ``limit`` files."""
    from PIL import Image  # only when a local LFW directory is there

    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in _IMAGE_EXTENSIONS)
    names = sorted({p.parent.name for p in files})
    index = {n: i for i, n in enumerate(names)}
    imgs, labels = [], []
    for p in files[:limit]:
        img = Image.open(p).convert("L").resize((size, size))
        imgs.append(np.asarray(img, np.float32) / 255.0)
        labels.append(index[p.parent.name])
    return np.asarray(imgs, np.float32)[..., None], np.asarray(labels), \
        len(names)


def _synthetic_faces(n: int, n_people: int, size: int,
                     seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A parametric face a person (ellipse, eyes, mouth from the person's
    own generator), so identity is learnable."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_people, n)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    imgs = np.empty((n, size, size), np.float32)
    for i, p in enumerate(labels):
        prng = np.random.default_rng(5000 + int(p))
        cx, cy = prng.uniform(0.4, 0.6, 2)
        rx, ry = prng.uniform(0.25, 0.35, 2)
        face = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1).astype(float)
        ex = prng.uniform(0.10, 0.16)
        ey = prng.uniform(0.10, 0.18)
        for sx in (-1, 1):
            face -= 0.8 * (((xx - (cx + sx * ex)) ** 2
                            + (yy - (cy - ey)) ** 2) < 0.002)
        mw = prng.uniform(0.08, 0.14)
        face -= 0.6 * ((np.abs(xx - cx) < mw)
                       & (np.abs(yy - (cy + 0.15)) < 0.02))
        imgs[i] = np.clip(face + rng.normal(0, 0.05, face.shape), 0, 1)
    return imgs, labels


class LFWDataSetIterator(ArrayDataSetIterator):
    """Labeled faces: ``[B, size, size, 1]`` greyscale and one-hot
    identities."""

    def __init__(self, batch: int, num_examples: int = 1000,
                 num_labels: int = 20, image_size: int = 28,
                 shuffle: bool = True, seed: int = 12):
        root = _find_lfw_dir()
        self.synthetic = root is None
        if root is not None:
            x, labels, num_labels = _read_image_dir(root, image_size,
                                                    num_examples)
        else:
            imgs, labels = _synthetic_faces(num_examples, num_labels,
                                            image_size, 99)
            x = imgs[..., None]
        super().__init__(x, _one_hot(labels, num_labels), batch,
                         shuffle=shuffle, seed=seed)


def _synthetic_curves(n: int, size: int, seed: int) -> np.ndarray:
    """Random cubic Bezier curves rasterized on a ``size x size`` grid,
    flattened."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size), np.float32)
    t = np.linspace(0, 1, 6 * size)
    for i in range(n):
        pts = rng.uniform(0.1, 0.9, (4, 2))
        b = ((1 - t)[:, None] ** 3 * pts[0] + 3 * (1 - t)[:, None] ** 2
             * t[:, None] * pts[1] + 3 * (1 - t)[:, None] * t[:, None] ** 2
             * pts[2] + t[:, None] ** 3 * pts[3])
        rows = np.clip((b[:, 1] * (size - 1)).astype(int), 0, size - 1)
        cols = np.clip((b[:, 0] * (size - 1)).astype(int), 0, size - 1)
        imgs[i, rows, cols] = 1.0
    return imgs.reshape(n, -1)


class CurvesDataSetIterator(ArrayDataSetIterator):
    """Curve images for autoencoder pretraining; the labels are the
    features."""

    def __init__(self, batch: int, num_examples: int = 2000, size: int = 28,
                 seed: int = 12):
        x = _synthetic_curves(num_examples, size, 17)
        self.synthetic = True
        super().__init__(x, x.copy(), batch, shuffle=False, seed=seed)


class IrisDataSetIterator(ArrayDataSetIterator):
    """Three Gaussian clusters with iris-like means and spreads in 4-D, in a
    seeded random order, one-hot labels; no shuffling between epochs."""

    _MEANS = np.array([[5.0, 3.4, 1.5, 0.2],
                       [5.9, 2.8, 4.3, 1.3],
                       [6.6, 3.0, 5.6, 2.0]], np.float32)
    _STDS = np.array([[0.35, 0.38, 0.17, 0.10],
                      [0.52, 0.31, 0.47, 0.20],
                      [0.64, 0.32, 0.55, 0.27]], np.float32)

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 42):
        rng = np.random.default_rng(seed)
        per = num_examples // 3
        x = np.concatenate([rng.normal(self._MEANS[c], self._STDS[c],
                                       (per, 4)).astype(np.float32)
                            for c in range(3)])
        y = np.repeat(np.arange(3), per)
        idx = rng.permutation(len(x))
        self.synthetic = True
        super().__init__(x[idx], _one_hot(y[idx], 3), batch, shuffle=False)
