"""Utilities of the port. So far the random number generators (:mod:`.rng`),
copied from the JAX package's ``utils/rng.py``; the rest of ``utils`` is
ROADMAP queue 1 item 13."""

from .rng import CMWC, RandomGenerator, device_gaussian, device_uniform, ltqnorm  # noqa: F401
