"""Counter-based random numbers and blue noise (the parts of
``raytracer3_tpu_torch/ops/rng.py`` that the benchmark's plain reference
uses, frozen).

Unsigned 32-bit words are carried in int64 tensors holding values in
[0, 2**32): CPU torch has no uint32 shifts or adds. Every add, shift and
product is masked back to 32 bits; a product of two 32-bit words may wrap the
int64, which keeps its low 32 bits exact.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from rtbench.reference import mathx

_M32 = 0xFFFFFFFF


def frame_word(frame_index):
    """A frame index as its uint32 word: a Python int on the host, or an
    int64 tensor where the index is a (0-d) tensor, as a compiled step
    passes it; the same value either way."""
    if isinstance(frame_index, torch.Tensor):
        return frame_index.to(torch.int64) & _M32
    return int(frame_index) & _M32


def jenkins_hash(a: torch.Tensor) -> torch.Tensor:
    """Bob Jenkins' 6-shift integer hash (random.slang:5-15)."""
    a = a.to(torch.int64) & _M32
    a = ((a + 0x7ED55D16) + (a << 12)) & _M32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & _M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _M32
    a = ((a + 0xFD7046C5) + (a << 3)) & _M32
    a = (a ^ 0xB55A4F09) ^ (a >> 16)
    return a


def _rot32(x: torch.Tensor, y: int) -> torch.Tensor:
    return ((x << y) | (x >> (32 - y))) & _M32


def murmur3(seed: torch.Tensor, index) -> torch.Tensor:
    """One MurmurHash3 round + finalizer keyed on (seed, counter)
    (random.slang:52-81). ``index`` is an int or a tensor of counters."""
    seed = seed.to(torch.int64) & _M32
    if isinstance(index, torch.Tensor):
        k = ((index.to(torch.int64) & _M32) * 0xCC9E2D51) & _M32
        k = _rot32(k, 15)
        k = (k * 0x1B873593) & _M32
    else:
        # A scalar counter's key is host arithmetic on Python ints.
        k = ((int(index) & _M32) * 0xCC9E2D51) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * 0x1B873593) & _M32
    h = seed ^ k
    h = (_rot32(h, 13) * 5 + 0xE6546B64) & _M32
    h = h ^ 4
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def bits_to_unit_float(v: torch.Tensor) -> torch.Tensor:
    """uint32 bits → [0, 1) float via the mantissa trick (random.slang:83-90)."""
    bits = (v & ((1 << 23) - 1)) | 0x3F800000  # < 2**31: fits int32
    return bits.to(torch.int32).view(torch.float32) - 1.0


class Sampler(NamedTuple):
    """Per-lane RNG state: seed words plus a scalar draw counter (a Python
    int; the reference carries it as a traced uint32)."""

    seed: torch.Tensor  # int64 [...] holding uint32 values
    index: int = 0

    @staticmethod
    def from_pixels(pixel_xy: torch.Tensor, frame_index) -> "Sampler":
        """seed = jenkins_hash(zcurve(pixel)) + frame (random.slang:37-49)."""
        seed = (jenkins_hash(mathx.zcurve_index(pixel_xy)) + frame_word(frame_index)) & _M32
        return Sampler(seed=seed, index=0)

    def next1(self) -> Tuple[torch.Tensor, "Sampler"]:
        u = bits_to_unit_float(murmur3(self.seed, self.index))
        return u, Sampler(self.seed, (self.index + 1) & _M32)

    def next3(self) -> Tuple[torch.Tensor, "Sampler"]:
        u0, s = self.next1()
        u1, s = s.next1()
        u2, s = s.next1()
        return torch.stack([u0, u1, u2], dim=-1), s


def generate_blue_noise(size: int = 64, sigma: float = 1.9, seed: int = 0) -> np.ndarray:
    """Void-and-cluster blue-noise rank texture → float32 [size, size] in
    [0,1). Host-side numpy, identical to the reference's generator."""
    rng = np.random.default_rng(seed)
    n = size * size

    # Toroidal gaussian filter via FFT.
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    dist2 = d[:, None] ** 2 + d[None, :] ** 2
    kernel = np.exp(-dist2 / (2.0 * sigma * sigma))
    kernel_ft = np.fft.rfft2(kernel)

    def energy(binary):
        return np.fft.irfft2(np.fft.rfft2(binary) * kernel_ft, s=(size, size))

    # Initial pattern: ~10% random ones, relaxed to a cluster-free state.
    ones = max(1, n // 10)
    binary = np.zeros((size, size))
    idx = rng.choice(n, ones, replace=False)
    binary.ravel()[idx] = 1.0
    for _ in range(4 * n):
        e = energy(binary)
        cluster = np.unravel_index(np.argmax(np.where(binary > 0, e, -np.inf)), e.shape)
        binary[cluster] = 0.0
        e = energy(binary)
        void = np.unravel_index(np.argmin(np.where(binary > 0, np.inf, e)), e.shape)
        if void == cluster:
            binary[cluster] = 1.0
            break
        binary[void] = 1.0

    rank = np.zeros((size, size), dtype=np.int64)
    # Phase 1: remove tightest clusters, rank down.
    work = binary.copy()
    for r in range(ones - 1, -1, -1):
        e = energy(work)
        cluster = np.unravel_index(np.argmax(np.where(work > 0, e, -np.inf)), e.shape)
        work[cluster] = 0.0
        rank[cluster] = r
    # Phase 2: fill largest voids, rank up.
    work = binary.copy()
    for r in range(ones, n):
        e = energy(work)
        void = np.unravel_index(np.argmin(np.where(work > 0, np.inf, e)), e.shape)
        work[void] = 1.0
        rank[void] = r

    return (rank.astype(np.float32) + 0.5) / float(n)


def animate_blue_noise(bn: torch.Tensor, frame_index: Union[int, torch.Tensor]) -> torch.Tensor:
    """Cranley-Patterson rotation of a static blue-noise texture by the
    golden-ratio sequence (float32 arithmetic, as the reference)."""
    g = np.float32(0.6180339887498949)
    if isinstance(frame_index, torch.Tensor):
        shift = g.item() * frame_index.to(torch.float32)
    else:
        shift = float(g * np.float32(frame_index))  # the float32 product, on the host
    v = bn + shift
    return v - torch.floor(v)
