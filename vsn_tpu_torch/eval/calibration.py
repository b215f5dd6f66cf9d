"""Post-hoc probability calibration: a copy of vsn_tpu/eval/calibration.py,
which the port may not import, on numpy and scipy alone.

Method parity with reference utils/calibration.py:9-267:
  * TemperatureScaling — Nelder-Mead NLL minimization over a scalar T applied
    to logits (29-111);
  * PlattScaling — per-class one-vs-rest logistic regression on the class
    logit, renormalized (114-191);
  * IsotonicCalibration — per-class isotonic regression on probabilities,
    renormalized (194-267).

The JAX package fits the last two with scikit-learn, which the card's
machine lacks; here they are scikit-learn's computations written out:
``LogisticRegression(solver="lbfgs", max_iter=1000)`` (C = 1, an L2
penalty on the slope only) as the same scipy L-BFGS-B call on the same
half-binomial loss and gradient, and ``IsotonicRegression(out_of_bounds=
"clip")`` as scipy's isotonic regression over the sorted, de-duplicated
points and a linear interpolation between the kept thresholds. All
host-side; calibration operates on saved prediction arrays, never on the
device hot path.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import isotonic_regression, minimize
from scipy.special import softmax


class TemperatureScaling:
    """Scalar temperature fitted by Nelder-Mead on validation NLL."""

    def __init__(self):
        self.temperature = 1.0
        self.fitted = False

    def fit(self, logits: np.ndarray, labels: np.ndarray, verbose: bool = False):
        labels = np.asarray(labels).astype(np.int64)
        logits = np.asarray(logits, np.float64)

        def nll(t):
            t = t[0]
            if t <= 0:
                return 1e10
            p = softmax(logits / t, axis=1)
            p = np.clip(p, 1e-10, 1.0)
            return -np.mean(np.log(p[np.arange(len(labels)), labels]))

        result = minimize(nll, x0=[1.0], method="Nelder-Mead",
                          options={"maxiter": 1000})
        self.temperature = float(result.x[0])
        self.fitted = True
        if verbose:
            print(f"TemperatureScaling: T={self.temperature:.4f} "
                  f"NLL {nll([1.0]):.4f} -> {result.fun:.4f}")
        return self

    def transform(self, logits: np.ndarray) -> np.ndarray:
        t = self.temperature if self.fitted else 1.0
        return softmax(np.asarray(logits, np.float64) / t, axis=1)

    def fit_transform(self, logits, labels, verbose: bool = False):
        return self.fit(logits, labels, verbose).transform(logits)


def _binomial_loss_gradient(coef, x, y, l2_reg_strength):
    """scikit-learn's LinearModelLoss(HalfBinomialLoss).loss_gradient for
    one feature with an intercept: the mean half-binomial loss of raw =
    x w + b plus l2_reg_strength / 2 w^2, and its gradient in (w, b). The
    per-sample branches are _loss.pyx's closs_grad_half_binomial."""
    w, b = coef[:1], coef[1]
    raw = x @ w + b
    lo, mid, hi = raw <= -37, (raw > -37) & (raw <= -2), raw > -2
    loss = np.empty_like(raw)
    grad = np.empty_like(raw)
    e = np.exp(raw[lo])
    loss[lo], grad[lo] = e - y[lo] * raw[lo], e - y[lo]
    e = np.exp(raw[mid])
    loss[mid] = np.log1p(e) - y[mid] * raw[mid]
    grad[mid] = ((1 - y[mid]) * e - y[mid]) / (1 + e)
    r, yy = raw[hi], y[hi]
    e = np.exp(-r)
    big = r > 18
    loss[hi] = np.where(big, e, np.log1p(e)) + (1 - yy) * r
    grad[hi] = ((1 - yy) - yy * e) / (1 + e)
    n = len(y)
    value = float(np.sum(loss) / n) + float(0.5 * l2_reg_strength * (w @ w))
    grad /= n
    out = np.empty_like(coef)
    out[:1] = x.T @ grad + l2_reg_strength * w
    out[1] = np.sum(grad)
    return value, out


class _Logistic:
    """One binary logistic regression on one feature (scikit-learn's
    lbfgs path: w0 = 0, gtol 1e-4, ftol 64 eps, maxls 50)."""

    def __init__(self, c: float = 1.0, max_iter: int = 1000,
                 tol: float = 1e-4):
        self.c, self.max_iter, self.tol = c, max_iter, tol

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, np.float64).reshape(-1, 1)
        y = np.asarray(y, np.float64)
        if len(np.unique(y)) < 2:
            raise ValueError("This solver needs samples of at least 2 "
                             "classes in the data")
        res = minimize(
            _binomial_loss_gradient, np.zeros(2), method="L-BFGS-B",
            jac=True, args=(x, y, 1.0 / (self.c * len(y))),
            options={"maxiter": self.max_iter, "maxls": 50,
                     "gtol": self.tol, "ftol": 64 * np.finfo(float).eps})
        self.coef_, self.intercept_ = res.x[:1], res.x[1]
        return self

    def predict_proba_positive(self, x: np.ndarray) -> np.ndarray:
        raw = np.asarray(x, np.float64).reshape(-1, 1) @ self.coef_ \
            + self.intercept_
        return 1.0 / (1.0 + np.exp(-raw))


class PlattScaling:
    """Per-class OVR logistic regression on the class logit."""

    def __init__(self):
        self.models = {}
        self.fitted = False

    def fit(self, logits: np.ndarray, labels: np.ndarray, verbose: bool = False):
        logits = np.asarray(logits, np.float64)
        labels = np.asarray(labels).astype(np.int64)
        for c in range(logits.shape[1]):
            self.models[c] = _Logistic().fit(logits[:, c],
                                             (labels == c).astype(int))
        self.fitted = True
        return self

    def transform(self, logits: np.ndarray) -> np.ndarray:
        if not self.fitted:
            raise ValueError("PlattScaling not fitted")
        logits = np.asarray(logits, np.float64)
        out = np.zeros_like(logits)
        for c, model in self.models.items():
            out[:, c] = model.predict_proba_positive(logits[:, c])
        return out / out.sum(axis=1, keepdims=True)


class _Isotonic:
    """Increasing isotonic regression of y on x, predictions clipped to the
    fitted x range (scikit-learn's IsotonicRegression(out_of_bounds=
    "clip") with unit weights)."""

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, np.float64).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        order = np.lexsort((y, x))
        x, y = x[order], y[order]
        # average y over x values closer than the float resolution
        eps = np.finfo(np.float64).resolution
        ux, uy, uw = [], [], []
        cur_x, cur_y, cur_w = x[0], 0.0, 0.0
        for xj, yj in zip(x, y):
            if xj - cur_x >= eps:
                ux.append(cur_x)
                uw.append(cur_w)
                uy.append(cur_y / cur_w)
                cur_x, cur_w, cur_y = xj, 1.0, yj
            else:
                cur_w += 1.0
                cur_y += yj
        ux.append(cur_x)
        uw.append(cur_w)
        uy.append(cur_y / cur_w)
        x = np.asarray(ux)
        y = np.asarray(isotonic_regression(np.asarray(uy), weights=np.asarray(
            uw), increasing=True).x, dtype=np.float64)
        self.x_min_, self.x_max_ = np.min(x), np.max(x)
        keep = np.ones(len(y), dtype=bool)
        keep[1:-1] = np.logical_or(np.not_equal(y[1:-1], y[:-2]),
                                   np.not_equal(y[1:-1], y[2:]))
        self.x_, self.y_ = x[keep], y[keep]
        return self

    def predict(self, t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, np.float64).reshape(-1), self.x_min_,
                    self.x_max_)
        if len(self.y_) == 1:
            return self.y_.repeat(t.shape)
        return interp1d(self.x_, self.y_, kind="linear",
                        bounds_error=False)(t).astype(t.dtype)


class IsotonicCalibration:
    """Per-class isotonic regression on probabilities (not logits)."""

    def __init__(self):
        self.calibrators = {}
        self.fitted = False

    def fit(self, probs: np.ndarray, labels: np.ndarray, verbose: bool = False):
        probs = np.asarray(probs, np.float64)
        labels = np.asarray(labels).astype(np.int64)
        for c in range(probs.shape[1]):
            cal = _Isotonic().fit(probs[:, c], (labels == c).astype(int))
            self.calibrators[c] = cal
        self.fitted = True
        return self

    def transform(self, probs: np.ndarray) -> np.ndarray:
        if not self.fitted:
            raise ValueError("IsotonicCalibration not fitted")
        probs = np.asarray(probs, np.float64)
        out = np.zeros_like(probs)
        for c, cal in self.calibrators.items():
            out[:, c] = cal.predict(probs[:, c])
        s = out.sum(axis=1, keepdims=True)
        s[s == 0] = 1.0
        return out / s


def make_calibrator(method: str):
    """'temperature' | 'platt' | 'isotonic' (reference
    utils/calibrate_predictions.py method flag)."""
    return {
        "temperature": TemperatureScaling,
        "platt": PlattScaling,
        "isotonic": IsotonicCalibration,
    }[method]()
