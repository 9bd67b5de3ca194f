"""Synthetic datasets (numpy only; a copy of ``repro.data.synthetic`` so
the port depends on nothing of the reference package).

Two generators:

* ``digits``: procedural 28x28 digit glyphs (5x7 font, upscaled, jittered,
  noised) — the MNIST stand-in used by the quickstart and the accuracy
  benchmarks.  Same booleanized dimensionality as the paper (K = 2*28*28).
* ``prototype``: per-class random Boolean prototypes + bit-flip noise, with
  configurable (#classes, #features) — used to instantiate Table 5's seven
  datasets at their published literal/clause/class dimensions.
"""
from __future__ import annotations

import numpy as np

_FONT = {
    0: [".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."],
    1: ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    2: [".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"],
    3: [".###.", "#...#", "....#", "..##.", "....#", "#...#", ".###."],
    4: ["...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."],
    5: ["#####", "#....", "####.", "....#", "....#", "#...#", ".###."],
    6: ["..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."],
    7: ["#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."],
    8: [".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."],
    9: [".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."],
}


def _glyph(digit: int) -> np.ndarray:
    rows = _FONT[digit]
    g = np.array([[c == "#" for c in r] for r in rows], dtype=np.float32)
    # Upscale 5x7 -> 15x21 (x3), leaving room to jitter inside 28x28.
    return np.kron(g, np.ones((3, 3), np.float32))


def digits(n: int, *, seed: int = 0, noise: float = 0.03,
           jitter: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, 784) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.zeros((n, 28, 28), np.float32)
    glyphs = {d: _glyph(d) for d in range(10)}
    for i, d in enumerate(labels):
        g = glyphs[int(d)]
        h, w = g.shape
        dy = rng.integers(0, 28 - h - jitter) + rng.integers(0, jitter + 1)
        dx = rng.integers(0, 28 - w - jitter) + rng.integers(0, jitter + 1)
        canvas = rng.uniform(0.0, 0.15, (28, 28)).astype(np.float32)
        patch = np.where(g > 0, rng.uniform(0.6, 1.0, g.shape), canvas[dy:dy + h, dx:dx + w])
        canvas[dy:dy + h, dx:dx + w] = patch
        flip = rng.random((28, 28)) < noise
        canvas = np.where(flip, 1.0 - canvas, canvas)
        imgs[i] = canvas
    return imgs.reshape(n, 784), labels


def prototype(n: int, *, n_classes: int, n_features: int,
              protos_per_class: int = 2, flip: float = 0.08,
              seed: int = 0, proto_seed: int = 1234,
              ) -> tuple[np.ndarray, np.ndarray]:
    """Boolean prototype datasets: sample a class prototype, flip bits.

    ``proto_seed`` fixes the class prototypes (shared across train/test
    splits); ``seed`` drives the per-sample draws.
    """
    proto_rng = np.random.default_rng(proto_seed)
    rng = np.random.default_rng(seed)
    protos = proto_rng.random((n_classes, protos_per_class, n_features)) < 0.5
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    which = rng.integers(0, protos_per_class, size=n)
    x = protos[labels, which].astype(np.float32)
    mask = rng.random((n, n_features)) < flip
    x = np.where(mask, 1.0 - x, x)
    return x, labels


# Table 5 dataset stand-ins: (classes, clauses, literals) from the paper.
TABLE5 = {
    "iris":           dict(classes=3,  clauses=12,   literals=32),
    "cifar2":         dict(classes=2,  clauses=1000, literals=2048),
    "kws6":           dict(classes=6,  clauses=300,  literals=754),
    "fashion_mnist":  dict(classes=10, clauses=500,  literals=1568),
    "emg":            dict(classes=7,  clauses=300,  literals=192),
    "gesture_phase":  dict(classes=5,  clauses=300,  literals=424),
    "human_activity": dict(classes=6,  clauses=800,  literals=1632),
}


def table5_dataset(name: str, n: int, *, seed: int = 0,
                   flip: float = 0.08) -> tuple[np.ndarray, np.ndarray, dict]:
    """Synthetic stand-in at the paper's published dimensions.

    Features = literals/2 (negations are appended by the booleanizer).
    """
    spec = TABLE5[name]
    x, y = prototype(n, n_classes=spec["classes"],
                     n_features=spec["literals"] // 2, flip=flip, seed=seed)
    return x, y, spec
