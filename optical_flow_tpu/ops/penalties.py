"""Robust penalty functions, functional and trace-friendly.

Each penalty exposes three modes matching the reference semantics
(``robust/penalties.py``):

* ``value(x)``  — rho(x)
* ``deriv(x)``  — rho'(x)
* ``weight(x)`` — rho'(x) / x, the IRLS weight

The reference wraps these in a mutable ``RobustFunction`` object; here a
penalty is a frozen, hashable :class:`Robust` descriptor whose parameters are
*trace-time constants*, so method configurations stay static under ``jit``
and each (penalty, params) pair folds into compiled code.

All math is elementwise ``jax.numpy`` — it fuses into
surrounding stencil programs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
from jax.scipy.special import gammaln


# ---------------------------------------------------------------------------
# penalty kernels: f(x, params, d_type) -> array
# ---------------------------------------------------------------------------


def quadratic(x, p, d_type):
    """rho(x) = x^2 / sigma^2  (reference ``penalties.py:18-41``)."""
    sig2 = p[0] ** 2
    if d_type == 0:
        return x**2 / sig2
    if d_type == 1:
        return 2.0 * x / sig2
    return jnp.full_like(x, 2.0 / sig2)


def lorentzian(x, p, d_type):
    """rho(x) = log(1 + x^2 / (2 sigma^2))  (reference ``penalties.py:44-67``)."""
    sig2 = p[0] ** 2
    if d_type == 0:
        return jnp.log1p(x**2 / (2.0 * sig2))
    if d_type == 1:
        return 2.0 * x / (2.0 * sig2 + x**2)
    return 2.0 / (2.0 * sig2 + x**2)


def charbonnier(x, p, d_type):
    """MATLAB-exact Charbonnier with sigma^2 (not sigma) scaling.

    Reference ``penalties.py:70-102``: rho = 1 + (x / sig^2)^2, and the
    value / deriv / weight are sig2*sqrt(rho), x/(sig2*sqrt(rho)),
    1/(sig2*sqrt(rho)).
    """
    sig2 = p[0] ** 2
    sqrt_rho = jnp.sqrt(1.0 + (x / sig2) ** 2)
    if d_type == 0:
        return sig2 * sqrt_rho
    if d_type == 1:
        return x / (sig2 * sqrt_rho)
    return 1.0 / (sig2 * sqrt_rho)


def generalized_charbonnier(x, p, d_type):
    """rho(x) = (sig^2 + x^2)^a  (reference ``penalties.py:105-131``)."""
    sig, a = p[0], p[1]
    base = sig**2 + x**2
    if d_type == 0:
        return base**a
    if d_type == 1:
        return 2.0 * a * x * base ** (a - 1.0)
    return 2.0 * a * base ** (a - 1.0)


def geman_mcclure(x, p, d_type):
    """rho(x) = x^2 / (sigma^2 + x^2)  (reference ``penalties.py:134-158``)."""
    sig2 = p[0] ** 2
    denom = sig2 + x**2
    if d_type == 0:
        return x**2 / denom
    if d_type == 1:
        return 2.0 * sig2 * x / denom**2
    return 2.0 * sig2 / denom**2


def huber(x, p, d_type):
    """Huber with threshold at |x| <= sigma^2 (MATLAB convention).

    Reference ``penalties.py:161-198``.
    """
    sig2 = p[0] ** 2
    absx = jnp.abs(x)
    mask = absx <= sig2
    if d_type == 0:
        return jnp.where(mask, x**2, 2.0 * sig2 * absx - sig2**2)
    if d_type == 1:
        return jnp.where(mask, 2.0 * x, 2.0 * sig2 * jnp.sign(x))
    return jnp.where(mask, 2.0, 2.0 * sig2 / jnp.maximum(absx, 1e-30))


def tukey(x, p, d_type):
    """Tukey biweight, saturating at 1/3 (reference ``penalties.py:201-240``)."""
    sig = p[0]
    sig2 = sig**2
    mask = jnp.abs(x) <= sig
    one_minus = 1.0 - x**2 / sig2
    if d_type == 0:
        return jnp.where(mask, (1.0 - one_minus**3) / 3.0, 1.0 / 3.0)
    if d_type == 1:
        return jnp.where(mask, 2.0 * x * one_minus**2 / sig2, 0.0)
    return jnp.where(mask, 2.0 * one_minus**2 / sig2, 0.0)


def gaussian(x, p, d_type):
    """Gaussian negative log-likelihood (reference ``penalties.py:243-268``)."""
    sig = p[0]
    sig2 = sig**2
    if d_type == 0:
        return 0.5 * jnp.log(2.0 * jnp.pi) + jnp.log(sig) + 0.5 * (x / sig) ** 2
    if d_type == 1:
        return x / sig2
    return jnp.full_like(x, 1.0 / sig2)


def tdist(x, p, d_type):
    """Normalized Student-t penalty, params (r, s) (reference ``penalties.py:271-313``)."""
    r, s = p[0], p[1]
    s2r = s**2 * r
    if d_type == 0:
        cnst = (
            gammaln(r / 2.0)
            - gammaln((r + 1.0) / 2.0)
            + 0.5 * jnp.log(r * jnp.pi)
            + jnp.log(s)
        )
        return (r + 1.0) / 2.0 * jnp.log1p(x**2 / s2r) + cnst
    if d_type == 1:
        return (r + 1.0) * x / (s2r + x**2)
    return (r + 1.0) / (s2r + x**2)


def tdist_unnorm(x, p, d_type):
    """Student-t without the normalizer (reference ``penalties.py:316-345``)."""
    r, s = p[0], p[1]
    s2r = s**2 * r
    if d_type == 0:
        return (r + 1.0) / 2.0 * jnp.log1p(x**2 / s2r)
    if d_type == 1:
        return (r + 1.0) * x / (s2r + x**2)
    return (r + 1.0) / (s2r + x**2)


PENALTIES = {
    "quadratic": quadratic,
    "lorentzian": lorentzian,
    "charbonnier": charbonnier,
    "generalized_charbonnier": generalized_charbonnier,
    "geman_mcclure": geman_mcclure,
    "huber": huber,
    "tukey": tukey,
    "gaussian": gaussian,
    "tdist": tdist,
    "tdist_unnorm": tdist_unnorm,
}

# Named but unimplemented in the reference too (``penalties.py:348-373``).
UNIMPLEMENTED_PENALTIES = ("mixture", "spline_penalty")


def mixture(x, sigma, d_type):
    """Mixture penalty — unimplemented, matching the reference surface."""
    raise NotImplementedError(
        "Mixture penalty is not yet implemented (matches reference)."
    )


def spline_penalty(x, sigma, d_type):
    """Spline penalty — unimplemented, matching the reference surface."""
    raise NotImplementedError("Spline penalty is not yet implemented.")


@dataclasses.dataclass(frozen=True)
class Robust:
    """Frozen descriptor of a robust penalty: (name, params).

    Hashable so it can live in static method configs.  Mirrors the
    reference's ``RobustFunction`` (``robust/robust_function.py:30-145``)
    but as an immutable value object.
    """

    name: str
    params: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if self.name in UNIMPLEMENTED_PENALTIES:
            raise NotImplementedError(
                f"Penalty '{self.name}' is not implemented (matches reference)."
            )
        if self.name not in PENALTIES:
            raise ValueError(
                f"Unknown penalty '{self.name}'. Available: {sorted(PENALTIES)}"
            )
        object.__setattr__(self, "params", tuple(float(v) for v in self.params))

    # -- reference-compatible surface ------------------------------------
    @property
    def param(self):
        return self.params

    def evaluate(self, x):
        return PENALTIES[self.name](jnp.asarray(x), self.params, 0)

    def deriv(self, x):
        return PENALTIES[self.name](jnp.asarray(x), self.params, 1)

    def deriv_over_x(self, x):
        """IRLS weight rho'(x)/x."""
        return PENALTIES[self.name](jnp.asarray(x), self.params, 2)

    def evaluate_log(self, x):
        return self.evaluate(x)


def robust(name: str, *params) -> Robust:
    """Convenience constructor: ``robust('charbonnier', 1e-3)``."""
    return Robust(name, tuple(params) if params else (1.0,))
