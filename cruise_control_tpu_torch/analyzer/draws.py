"""The anneal's random-number generator: threefry2x32 keys and draws.

Reproduces `jax.random.PRNGKey` / `split` / `fold_in` / `uniform` and the
engine's `_uniform_idx` bit for bit, with jax 0.9's default
`jax_threefry_partitionable=True`.  threefry is a defined integer function,
so the port draws exactly the reference's candidate stream and whole
trajectories can be held against it.

A `Key` is two uint32 words kept on the host: deriving keys (`split`,
`fold_in`) hashes a handful of counters, which costs microseconds in
Python and needs no device round trip.  An anneal step's draws are hashed
inside the candidates kernel (kernels/candidates.py) under the keys the
host derives; `uniform` and `uniform_idx` here draw a whole stream, with
the `threefry_uniform` kernel (kernels/threefry.py) on CUDA.
"""

from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.kernels import threefry

MASK32 = threefry.MASK32


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry2x32 key: the two uint32 words of a `jax.random.PRNGKey`."""

    k0: int
    k1: int

    @staticmethod
    def from_seed(seed: int) -> "Key":
        """= jax.random.PRNGKey(seed)."""
        seed = int(seed)
        return Key((seed >> 32) & MASK32, seed & MASK32)

    @property
    def words(self) -> tuple[int, int]:
        return (self.k0, self.k1)

    def split(self, n: int = 2) -> list["Key"]:
        """= jax.random.split(key, n): key i hashes the counter (0, i)."""
        return [Key(*threefry.threefry2x32(self.k0, self.k1, i >> 32, i & MASK32)) for i in range(n)]

    def fold_in(self, data: int) -> "Key":
        """= jax.random.fold_in(key, data)."""
        return Key(*threefry.threefry2x32(self.k0, self.k1, 0, int(data) & MASK32))


def uniform(
    key: Key, n: int, *, minval: float = 0.0, maxval: float = 1.0, device
) -> torch.Tensor:
    """f32[n] = jax.random.uniform(key, (n,), minval=minval, maxval=maxval)."""
    return threefry.uniform(key.words, n, minval=minval, maxval=maxval, device=device)


def uniform_idx(key: Key, n: int, bound: int, *, device) -> torch.Tensor:
    """i32[n] uniform indices in [0, bound) (engine.py:958 `_uniform_idx`)."""
    return threefry.uniform_idx(key.words, n, bound, device=device)
