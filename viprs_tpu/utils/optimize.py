"""Optimization bookkeeping objects.

Functional parity with the reference's ``viprs/utils/OptimizeResult.py`` (the
scipy-like result record with oscillation tracking, and the consecutive-condition
counter used for patience logic), re-implemented for this framework where most
convergence logic runs *on device* — these objects summarize the device-side
status codes for the host/CLI layer.
"""

import numpy as np


# Status codes emitted by the fused on-device EM loop (ops/em_loop.py). Order matters:
# codes >= CONVERGED_F and < MSE_NEGATIVE are successes.
RUNNING = 0
CONVERGED_F = 1          # ELBO absolute tolerance reached
CONVERGED_X = 2          # variational parameters (max |d_eta|) tolerance reached
CONVERGED_SIGMA_G = 3    # LD-weighted parameters stable for `patience` iterations
MSE_NEGATIVE = 4         # training MSE went negative (pathological)
ELBO_NONFINITE = 5
SIGMA_EPS_NEGATIVE = 6
H2_OUT_OF_BOUNDS = 7
DIVERGED_ELBO = 8        # ELBO consistently decreasing for `patience` iterations
MAX_ITER = 9

_SUCCESS_CODES = frozenset({CONVERGED_F, CONVERGED_X, CONVERGED_SIGMA_G})

STATUS_MESSAGES = {
    RUNNING: "Optimization still running.",
    CONVERGED_F: "Objective (ELBO) converged successfully.",
    CONVERGED_X: "Variational parameters converged successfully.",
    CONVERGED_SIGMA_G: "LD-weighted variational parameters converged successfully.",
    MSE_NEGATIVE: "The MSE is negative.",
    ELBO_NONFINITE: "Objective (ELBO) is undefined.",
    SIGMA_EPS_NEGATIVE: "Residual variance estimate is negative.",
    H2_OUT_OF_BOUNDS: "Estimated heritability is out of bounds.",
    DIVERGED_ELBO: "The objective (ELBO) is decreasing.",
    MAX_ITER: "Maximum iterations reached without convergence.\n"
              "You may need to run the model for more iterations.",
}


def status_is_success(code) -> bool:
    return int(code) in _SUCCESS_CODES


def status_is_error(code) -> bool:
    """Hard errors (as opposed to success or plain max-iter exhaustion)."""
    code = int(code)
    return code not in _SUCCESS_CODES and code not in (RUNNING, MAX_ITER)


class IterationConditionCounter:
    """Counts the number of *consecutive* iterations a condition held.

    Parity: viprs/utils/OptimizeResult.py:2-35.
    """

    def __init__(self):
        self._counter = 0
        self._nit = 0

    @property
    def counter(self):
        return self._counter

    def update(self, condition, iteration):
        if condition and (iteration == self._nit + 1):
            self._counter += 1
        else:
            self._counter = 0
        self._nit = iteration


class OptimizeResult:
    """A scipy-like record of the progress/outcome of an optimization run.

    Parity: viprs/utils/OptimizeResult.py:38-153 — including the oscillation
    counter (consecutive objective drops), which in this framework triggers
    *damping escalation* instead of the reference's thread-count reduction.
    """

    def __init__(self):
        self.message = None
        self.stop_iteration = None
        self.success = None
        self.fun = None
        self.nit = 0
        self.error_on_termination = False

        self._last_drop_iter = None
        self._oscillation_counter = 0

    @property
    def iterations(self):
        return self.nit

    @property
    def objective(self):
        return self.fun

    @property
    def converged(self):
        return self.success

    @property
    def valid_optim_result(self):
        """True if converged OR stopped without a hard error (e.g. max-iter)."""
        return bool(self.success or (self.stop_iteration and not self.error_on_termination))

    @property
    def oscillation_counter(self):
        return self._oscillation_counter

    def reset(self):
        self.message = None
        self.stop_iteration = False
        self.success = False
        self.fun = None
        self.nit = 0
        self.error_on_termination = False
        self._last_drop_iter = None
        self._oscillation_counter = 0

    def _reset_oscillation_counter(self):
        self._oscillation_counter = 0

    def update(self, fun, stop_iteration=False, success=False, message=None, increment=True):
        # Track consecutive objective drops (oscillation detection):
        if self.fun is not None and fun < self.fun:
            if self._last_drop_iter is not None and self.nit - self._last_drop_iter == 1:
                self._oscillation_counter += 1
            self._last_drop_iter = self.nit + 1
        elif self._last_drop_iter is not None and self.nit > self._last_drop_iter:
            self._reset_oscillation_counter()

        self.fun = fun
        self.stop_iteration = stop_iteration
        self.success = success
        self.message = message
        self.nit += int(increment)

        if stop_iteration and not success and "Maximum iterations" not in (message or ""):
            self.error_on_termination = True

    @classmethod
    def from_status(cls, code, fun, nit):
        """Build a result record from an on-device status code."""
        res = cls()
        res.fun = float(fun)
        res.nit = int(nit)
        res.stop_iteration = int(code) != RUNNING
        res.success = status_is_success(code)
        res.message = STATUS_MESSAGES.get(int(code), f"Unknown status code: {code}")
        res.error_on_termination = status_is_error(code)
        return res

    def __str__(self):
        return str(self.__dict__)


def summarize_statuses(codes, elbos, nits):
    """Vector version of ``from_status`` for grid models: one record per model."""
    return [OptimizeResult.from_status(c, f, n)
            for c, f, n in zip(np.atleast_1d(codes), np.atleast_1d(elbos), np.atleast_1d(nits))]
