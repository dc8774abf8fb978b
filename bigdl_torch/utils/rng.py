"""RandomGenerator: seeded sampling of the reference's distributions.

Counterpart of ``bigdl_tpu/utils/rng.py`` (reference
``utils/RandomGenerator.scala:23``, its distributions at ``:224-270``):
uniform, normal, exponential, Cauchy, log-normal, geometric and Bernoulli
samples drawn from one ``torch.Generator`` on the host, made from the
seed at the first draw.  A seed gives the same stream every run; it is
not the JAX package's stream, nor Torch7's.
"""

from __future__ import annotations

import math

import torch

__all__ = ["RandomGenerator", "RNG"]


class RandomGenerator:
    """A stateful sampler over a ``torch.Generator``; every method returns
    a float32 (int32 for ``geometric``, bool for ``bernoulli``) tensor of
    ``shape`` on the host."""

    def __init__(self, seed: int = 0):
        # made at the first draw, as the reference makes its key
        self._seed = seed
        self._gen = None

    def set_seed(self, seed: int):
        self._seed = seed
        self._gen = torch.Generator().manual_seed(seed)
        return self

    def get_seed(self) -> int:
        return self._seed

    @property
    def generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(self._seed)
        return self._gen

    def _rand(self, shape):
        return torch.rand(tuple(shape), generator=self.generator)

    def _randn(self, shape):
        return torch.randn(tuple(shape), generator=self.generator)

    # -- distributions (BigDL utils/RandomGenerator.scala:224-270) --

    def uniform(self, a=0.0, b=1.0, shape=()):
        return a + (b - a) * self._rand(shape)

    def normal(self, mean=0.0, stdv=1.0, shape=()):
        return mean + stdv * self._randn(shape)

    def exponential(self, lam=1.0, shape=()):
        return -torch.log1p(-self._rand(shape)) / lam

    def cauchy(self, median=0.0, sigma=1.0, shape=()):
        return median + sigma * torch.tan(math.pi * (self._rand(shape)
                                                     - 0.5))

    def log_normal(self, mean=1.0, stdv=2.0, shape=()):
        # Torch's meaning: mean and stdv are the log-normal variable's own
        var = stdv ** 2
        mu = math.log(mean ** 2 / math.sqrt(var + mean ** 2))
        sigma = math.sqrt(math.log(var / mean ** 2 + 1.0))
        return torch.exp(mu + sigma * self._randn(shape))

    def geometric(self, p=0.5, shape=()):
        u = self._rand(shape)
        return (torch.floor(torch.log1p(-u) / math.log1p(-p)) + 1).to(
            torch.int32)

    def bernoulli(self, p=0.5, shape=()):
        return self._rand(shape) < p


#: the process-wide generator (BigDL: RandomGenerator.RNG)
RNG = RandomGenerator(0)
