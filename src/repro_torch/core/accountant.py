"""Moments Accountant (Abadi et al., 2016) for the subsampled Gaussian
mechanism, as used by the paper for per-client privacy tracking.

The paper (Sec. 3.2, Eq. 7-8) tracks, per client k, the cumulative log
moments ``mu(lambda) = sum_t mu_t(lambda)`` and reports

    eps = min_lambda ( mu(lambda) - log(delta) ) / lambda .

For the Gaussian mechanism with per-sample clipping norm C, noise scale
``sigma * C`` and Poisson-style subsampling ratio ``q = B / |D_k|``, the
lambda-th log moment of one step admits the classical integer-order bound
(Abadi et al. Lemma 3 / Mironov's sampled-Gaussian RDP at integer orders):

    mu_t(lambda) = log( sum_{k=0}^{lambda+1} C(lambda+1, k)
                        (1-q)^{lambda+1-k} q^k  exp( k(k-1) / (2 sigma^2) ) )

(using the identity mu_MA(lambda) = log A(alpha) with alpha = lambda + 1,
where A(alpha) = E_{z~mu}[(mu/mu0)^alpha]).  Everything is computed in
log-space in float64, so large lambda / small sigma do not overflow.

This module is pure numpy (it runs on the host, per client, per round —
never inside a jitted step).

Dispatch-time cost: the engine's cohort scheduler charges the accountant
once per client dispatch, which makes the one-step moment computation
part of the server's host-side critical path (see
``repro.engine.engine``).  :func:`log_moments_vector` therefore computes
the whole one-step log-moment vector over all orders in one vectorized
numpy pass, and :func:`cached_log_moments` memoizes it per
``(q, sigma, orders)`` — a client population with homogeneous (q, sigma)
pays the O(orders * max_order) term construction ONCE per process and
every subsequent ``MomentsAccountant.step`` is a single O(orders)
fused-multiply-add.  :class:`EpsilonSchedule` goes one step further for
the engine's fixed per-round step counts: the whole epsilon-vs-round
trajectory of a client config is a lazily extended table, so dispatch
(and ``AdaptiveAsync`` budget checks) read epsilon by index instead of
re-minimizing over orders.

Pure-numpy copy of ``repro/core/accountant.py`` (the engine referred to
above is ``repro_torch.engine.engine`` in the port), held bitwise equal
by the parity tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

DEFAULT_ORDERS = tuple(range(1, 65)) + (80, 96, 128, 192, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def log_moment_subsampled_gaussian(q: float, sigma: float, lam: int) -> float:
    """One-step lambda-th log moment mu_t(lambda) for sampling ratio q,
    noise multiplier sigma.  Exact at integer orders."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling ratio q={q} outside [0, 1]")
    if sigma <= 0.0:
        return math.inf  # no noise => unbounded privacy loss
    if q == 0.0:
        return 0.0
    alpha = lam + 1
    if q == 1.0:
        # plain Gaussian mechanism: mu(lambda) = lambda (lambda+1) / (2 sigma^2)
        return lam * alpha / (2.0 * sigma * sigma)
    # log-sum-exp over k of:  logC(alpha,k) + (alpha-k)log(1-q) + k log q
    #                          + k(k-1)/(2 sigma^2)
    log_terms = np.array(
        [
            _log_comb(alpha, k)
            + (alpha - k) * math.log1p(-q)
            + k * math.log(q)
            + (k * (k - 1)) / (2.0 * sigma * sigma)
            for k in range(alpha + 1)
        ],
        dtype=np.float64,
    )
    m = log_terms.max()
    return float(m + math.log(np.exp(log_terms - m).sum()))


def log_moments_vector(q: float, sigma: float,
                       orders=DEFAULT_ORDERS) -> np.ndarray:
    """One-step log-moment VECTOR over ``orders`` in one vectorized pass.

    Produces exactly :func:`log_moment_subsampled_gaussian` evaluated at
    every order (the per-term IEEE operations and the per-order
    log-sum-exp reduction are kept in the scalar path's association, so
    the two agree bit-for-bit — the tier-1 fast-path test pins them to
    1e-12): the binomial/term matrix for all orders is built as one
    (n_orders, max_alpha + 1) numpy computation instead of n_orders
    Python list comprehensions.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling ratio q={q} outside [0, 1]")
    lams = np.asarray(orders, dtype=np.int64)
    alphas = lams + 1
    if sigma <= 0.0:
        return np.full(len(lams), math.inf)
    if q == 0.0:
        return np.zeros(len(lams))
    if q == 1.0:
        # plain Gaussian mechanism: mu(lambda) = lambda (lambda+1) / (2 sigma^2)
        return (lams * alphas) / (2.0 * sigma * sigma)
    a_max = int(alphas.max())
    # lgamma table: LG[m] = lgamma(m), so _log_comb(n, k) is
    # LG[n+1] - LG[k+1] - LG[n-k+1] with the scalar path's exact values
    # index 0 is never read (all lookups are >= 1); lgamma has a pole there
    lg = np.array([0.0] + [math.lgamma(m) for m in range(1, a_max + 2)])
    k = np.arange(a_max + 1, dtype=np.int64)
    log_comb = lg[alphas[:, None] + 1] - lg[k[None, :] + 1] \
        - lg[np.maximum(alphas[:, None] - k[None, :], 0) + 1]
    log1mq = math.log1p(-q)
    logq = math.log(q)
    # same left-to-right accumulation as the scalar term expression
    terms = ((log_comb + (alphas[:, None] - k[None, :]) * log1mq)
             + k[None, :] * logq) + (k * (k - 1)) / (2.0 * sigma * sigma)
    out = np.empty(len(lams))
    for i, alpha in enumerate(alphas):
        row = terms[i, : alpha + 1]          # the k = 0..alpha terms only
        m = row.max()
        out[i] = m + math.log(np.exp(row - m).sum())
    return out


# one-step log-moment vectors are pure functions of (q, sigma, orders):
# memoize them so per-dispatch accounting is an O(orders) increment, not a
# recomputation (the cached arrays are marked read-only — accountants
# accumulate into their own _mu, never into the cache)
_ONE_STEP_CACHE: dict = {}
_FAST_ACCOUNTING = True


def use_fast_accounting(enabled: bool) -> bool:
    """Toggle the memoized-vector fast path in ``MomentsAccountant.step``
    (returns the previous setting).  The scalar path is kept ONLY so the
    benchmarks can measure the pre-memoization dispatch cost — both paths
    produce identical moments (see tests/test_accountant.py)."""
    global _FAST_ACCOUNTING
    prev = _FAST_ACCOUNTING
    _FAST_ACCOUNTING = bool(enabled)
    return prev


def fast_accounting_enabled() -> bool:
    return _FAST_ACCOUNTING


def cached_log_moments(q: float, sigma: float,
                       orders=DEFAULT_ORDERS) -> np.ndarray:
    """Memoized :func:`log_moments_vector` (read-only array)."""
    key = (float(q), float(sigma), tuple(orders))
    vec = _ONE_STEP_CACHE.get(key)
    if vec is None:
        vec = log_moments_vector(q, sigma, orders)
        vec.setflags(write=False)
        _ONE_STEP_CACHE[key] = vec
    return vec


def epsilon_from_moments(log_moments: np.ndarray, orders, delta: float) -> float:
    """eps = min_lambda (mu(lambda) - log delta) / lambda   (paper Eq. 8)."""
    if delta <= 0 or delta >= 1:
        raise ValueError(f"delta={delta} outside (0, 1)")
    orders = np.asarray(orders, dtype=np.float64)
    mu = np.asarray(log_moments, dtype=np.float64)
    finite = np.isfinite(mu)
    if not finite.any():
        return math.inf
    if (mu[finite] <= 0).all():
        return 0.0  # no privacy loss accrued (e.g. q = 0): eps -> 0 as
                    # lambda -> inf, so the exact answer is 0
    eps = (mu[finite] - math.log(delta)) / orders[finite]
    return float(eps.min())


def delta_from_moments(log_moments: np.ndarray, orders, eps: float) -> float:
    """delta = min_lambda exp(mu(lambda) - lambda eps)   (paper Sec. 2.3)."""
    orders = np.asarray(orders, dtype=np.float64)
    mu = np.asarray(log_moments, dtype=np.float64)
    finite = np.isfinite(mu)
    if not finite.any():
        return 1.0
    # exp is monotone: min over lambda of exp(.) = exp(min of the exponent);
    # a non-negative exponent means delta >= 1, which caps at 1 anyway
    expo = float((mu[finite] - orders[finite] * eps).min())
    if expo >= 0.0:
        return 1.0
    return math.exp(expo)


@dataclass
class MomentsAccountant:
    """Tracks cumulative log moments for ONE client.

    The paper fixes (q, sigma) per client and accumulates over rounds;
    we allow heterogeneous steps too (q or sigma may change round to
    round, e.g. under the beyond-paper adaptive noise calibration).
    """

    orders: tuple = DEFAULT_ORDERS
    _mu: np.ndarray = field(default=None, repr=False)
    steps: int = 0

    def __post_init__(self):
        if self._mu is None:
            self._mu = np.zeros(len(self.orders), dtype=np.float64)

    def step(self, q: float, sigma: float, num_steps: int = 1) -> None:
        """Account for ``num_steps`` subsampled-Gaussian steps.

        The one-step log-moment vector comes from the per-(q, sigma)
        memo (:func:`cached_log_moments`), so repeated steps — one per
        dispatch in the engine's event loop — cost O(orders) instead of
        recomputing the O(orders * max_order) term matrix every round.
        """
        if num_steps <= 0:
            return
        if _FAST_ACCOUNTING:
            inc = cached_log_moments(q, sigma, self.orders)
        else:
            inc = np.array(
                [log_moment_subsampled_gaussian(q, sigma, lam)
                 for lam in self.orders],
                dtype=np.float64,
            )
        self._mu = self._mu + num_steps * inc
        self.steps += num_steps

    def epsilon(self, delta: float) -> float:
        if self.steps == 0:
            return 0.0
        return epsilon_from_moments(self._mu, self.orders, delta)

    def delta(self, eps: float) -> float:
        if self.steps == 0:
            return 0.0
        return delta_from_moments(self._mu, self.orders, eps)

    def copy(self) -> "MomentsAccountant":
        acc = MomentsAccountant(orders=self.orders)
        acc._mu = self._mu.copy()
        acc.steps = self.steps
        return acc


def compute_epsilon(
    q: float, sigma: float, steps: int, delta: float, orders=DEFAULT_ORDERS
) -> float:
    """Convenience one-shot: eps after ``steps`` identical DP-SGD steps."""
    acc = MomentsAccountant(orders=orders)
    acc.step(q, sigma, steps)
    return acc.epsilon(delta)


class EpsilonSchedule:
    """Precomputed epsilon-vs-round trajectory for ONE client config.

    The engine dispatches a client with a FIXED per-round step count
    (``steps_per_round`` is a function of (n_train, B, E)), so the whole
    epsilon trajectory is known up front: entry r is the epsilon a
    :class:`MomentsAccountant` reports after r identical round charges.
    The table accumulates the memoized one-step vector round by round —
    the SAME float64 addition sequence the accountant performs — so the
    lookup is bit-identical to stepping an accountant, and the
    ``AdaptiveAsync`` budget check at dispatch time is an array index
    instead of a min-over-orders recomputation.

    The table extends lazily in :meth:`epsilon_after_rounds`; use
    :func:`cached_epsilon_schedule` to share one schedule per distinct
    ``(q, sigma, steps_per_round, delta)`` across clients.
    """

    def __init__(self, q: float, sigma: float, steps_per_round: int,
                 delta: float, orders=DEFAULT_ORDERS):
        self.q = q
        self.sigma = sigma
        self.steps_per_round = int(steps_per_round)
        self.delta = delta
        self.orders = orders
        self._round_inc = (self.steps_per_round
                           * cached_log_moments(q, sigma, orders))
        self._mu = np.zeros(len(orders), dtype=np.float64)
        self._eps = [0.0]  # eps after 0 rounds

    def epsilon_after_rounds(self, rounds: int) -> float:
        """Epsilon after ``rounds`` dispatched local rounds (table lookup,
        extending the table when the run outlives it)."""
        if rounds < 0:
            raise ValueError(f"rounds={rounds} must be >= 0")
        if self.steps_per_round == 0:
            return 0.0  # no full batch => no charged steps (steps == 0)
        while len(self._eps) <= rounds:
            self._mu = self._mu + self._round_inc
            self._eps.append(
                epsilon_from_moments(self._mu, self.orders, self.delta))
        return self._eps[rounds]


_SCHEDULE_CACHE: dict = {}


def cached_epsilon_schedule(q: float, sigma: float, steps_per_round: int,
                            delta: float,
                            orders=DEFAULT_ORDERS) -> EpsilonSchedule:
    """One shared :class:`EpsilonSchedule` per distinct client config."""
    key = (float(q), float(sigma), int(steps_per_round), float(delta),
           tuple(orders))
    sched = _SCHEDULE_CACHE.get(key)
    if sched is None:
        sched = EpsilonSchedule(q, sigma, steps_per_round, delta, orders)
        _SCHEDULE_CACHE[key] = sched
    return sched
