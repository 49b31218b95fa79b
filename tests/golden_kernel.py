"""Golden-kernel harness: compile the REFERENCE's own C++ CAVI kernels
(viprs/model/vi/e_step.hpp, mounted read-only at /root/reference) into a shared
library and expose them via ctypes.

This is test infrastructure only — the reference header is #included from its
mounted location, never copied into this repository. Its purpose is to close
the "the clean-room NumPy reference (tests/reference_impl.py) might itself be
mistranscribed" hole behind every parity claim: one sweep and full fixed-point
runs of the compiled `e_step` / `e_step_mixture` / `e_step_grid` are asserted
against reference_impl and against this package's sweeps on identical inputs.
"""

import ctypes
import os
import os.path as osp
import subprocess

import numpy as np

REF_HEADER_DIR = '/root/reference/viprs/model/vi'
BUILD_DIR = osp.join(osp.dirname(osp.abspath(__file__)), '.golden_build')

_WRAPPER_SRC = r'''
// Thin extern-C shims over the reference's templated kernels.
// The header itself is #included from the read-only reference mount.
#include <cstdint>
#include "e_step.hpp"

extern "C" {

void ref_e_step_f64(int c_size, int* left, int64_t* indptr, double* ld,
                    double* std_beta, double* gamma, double* mu, double* eta,
                    double* q, double* eta_diff, double* u_logs,
                    double* sqrt_half_var_tau, double* mu_mult, double dq,
                    int threads, bool low_memory) {
    e_step<double, double, int64_t>(c_size, left, indptr, ld, std_beta, gamma,
                                    mu, eta, q, eta_diff, u_logs,
                                    sqrt_half_var_tau, mu_mult, dq, threads,
                                    low_memory);
}

void ref_e_step_i8(int c_size, int* left, int64_t* indptr, int8_t* ld,
                   double* std_beta, double* gamma, double* mu, double* eta,
                   double* q, double* eta_diff, double* u_logs,
                   double* sqrt_half_var_tau, double* mu_mult, double dq,
                   int threads, bool low_memory) {
    e_step<double, int8_t, int64_t>(c_size, left, indptr, ld, std_beta, gamma,
                                    mu, eta, q, eta_diff, u_logs,
                                    sqrt_half_var_tau, mu_mult, dq, threads,
                                    low_memory);
}

void ref_e_step_mixture_f64(int c_size, int K, int* left, int64_t* indptr,
                            double* ld, double* std_beta, double* gamma,
                            double* mu, double* eta, double* q,
                            double* eta_diff, double* log_null_pi,
                            double* u_logs, double* sqrt_half_var_tau,
                            double* mu_mult, double dq, int threads,
                            bool low_memory) {
    e_step_mixture<double, double, int64_t>(c_size, K, left, indptr, ld,
                                            std_beta, gamma, mu, eta, q,
                                            eta_diff, log_null_pi, u_logs,
                                            sqrt_half_var_tau, mu_mult, dq,
                                            threads, low_memory);
}

void ref_e_step_f32(int c_size, int* left, int64_t* indptr, float* ld,
                    float* std_beta, float* gamma, float* mu, float* eta,
                    float* q, float* eta_diff, float* u_logs,
                    float* sqrt_half_var_tau, float* mu_mult, float dq,
                    int threads, bool low_memory) {
    e_step<float, float, int64_t>(c_size, left, indptr, ld, std_beta, gamma,
                                  mu, eta, q, eta_diff, u_logs,
                                  sqrt_half_var_tau, mu_mult, dq, threads,
                                  low_memory);
}

void ref_e_step_mixture_f32(int c_size, int K, int* left, int64_t* indptr,
                            float* ld, float* std_beta, float* gamma,
                            float* mu, float* eta, float* q,
                            float* eta_diff, float* log_null_pi,
                            float* u_logs, float* sqrt_half_var_tau,
                            float* mu_mult, float dq, int threads,
                            bool low_memory) {
    e_step_mixture<float, float, int64_t>(c_size, K, left, indptr, ld,
                                          std_beta, gamma, mu, eta, q,
                                          eta_diff, log_null_pi, u_logs,
                                          sqrt_half_var_tau, mu_mult, dq,
                                          threads, low_memory);
}

void ref_e_step_grid_f64(int c_size, int n_active, int* active_idx, int* left,
                         int64_t* indptr, double* ld, double* std_beta,
                         double* gamma, double* mu, double* eta, double* q,
                         double* eta_diff, double* u_logs,
                         double* half_var_tau, double* mu_mult, double dq,
                         int threads, bool low_memory) {
    e_step_grid<double, double, int64_t>(c_size, n_active, active_idx, left,
                                         indptr, ld, std_beta, gamma, mu, eta,
                                         q, eta_diff, u_logs, half_var_tau,
                                         mu_mult, dq, threads, low_memory);
}

}  // extern "C"
'''

_F64 = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
_I8 = np.ctypeslib.ndpointer(np.int8, flags='C_CONTIGUOUS')
_I32 = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
_I64 = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')

_lib = None


def build_ref_kernel():
    """Compile (once, cached on disk) and load the reference kernel library.
    Returns the ctypes library or raises on toolchain/reference absence."""
    global _lib
    if _lib is not None:
        return _lib
    header = osp.join(REF_HEADER_DIR, 'e_step.hpp')
    if not osp.exists(header):
        raise FileNotFoundError(f"reference header not found: {header}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = osp.join(BUILD_DIR, 'ref_kernel_wrapper.cpp')
    so = osp.join(BUILD_DIR, 'libref_kernel.so')
    if not osp.exists(src) or open(src).read() != _WRAPPER_SRC:
        with open(src, 'w') as f:
            f.write(_WRAPPER_SRC)
    if (not osp.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(src),
                                          os.path.getmtime(header))):
        # Single-threaded ground truth: no OpenMP (the racy multithread mode is
        # explicitly an approximation, VIPRS.py:1056-1061), no CBLAS (the
        # manual FMA path is the always-available baseline).
        cmd = ['g++', '-O2', '-std=c++17', '-shared', '-fPIC',
               f'-I{REF_HEADER_DIR}', src, '-o', so]
        subprocess.run(cmd, check=True, capture_output=True, text=True)

    lib = ctypes.CDLL(so)
    _F32 = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    lib.ref_e_step_f32.restype = None
    lib.ref_e_step_f32.argtypes = [
        ctypes.c_int, _I32, _I64, _F32, _F32, _F32, _F32, _F32, _F32, _F32,
        _F32, _F32, _F32, ctypes.c_float, ctypes.c_int, ctypes.c_bool]
    lib.ref_e_step_mixture_f32.restype = None
    lib.ref_e_step_mixture_f32.argtypes = [
        ctypes.c_int, ctypes.c_int, _I32, _I64, _F32, _F32, _F32, _F32, _F32,
        _F32, _F32, _F32, _F32, _F32, _F32, ctypes.c_float, ctypes.c_int,
        ctypes.c_bool]
    lib.ref_e_step_f64.restype = None
    lib.ref_e_step_f64.argtypes = [
        ctypes.c_int, _I32, _I64, _F64, _F64, _F64, _F64, _F64, _F64, _F64,
        _F64, _F64, _F64, ctypes.c_double, ctypes.c_int, ctypes.c_bool]
    lib.ref_e_step_i8.restype = None
    lib.ref_e_step_i8.argtypes = [
        ctypes.c_int, _I32, _I64, _I8, _F64, _F64, _F64, _F64, _F64, _F64,
        _F64, _F64, _F64, ctypes.c_double, ctypes.c_int, ctypes.c_bool]
    lib.ref_e_step_mixture_f64.restype = None
    lib.ref_e_step_mixture_f64.argtypes = [
        ctypes.c_int, ctypes.c_int, _I32, _I64, _F64, _F64, _F64, _F64, _F64,
        _F64, _F64, _F64, _F64, _F64, _F64, ctypes.c_double, ctypes.c_int,
        ctypes.c_bool]
    lib.ref_e_step_grid_f64.restype = None
    lib.ref_e_step_grid_f64.argtypes = [
        ctypes.c_int, ctypes.c_int, _I32, _I32, _I64, _F64, _F64, _F64, _F64,
        _F64, _F64, _F64, _F64, _F64, _F64, ctypes.c_double, ctypes.c_int,
        ctypes.c_bool]
    _lib = lib
    return lib


def dense_to_banded(R, triangular=False, dtype=np.float64):
    """Dense symmetric R -> (data, indptr, left) with full nonzero windows.

    ``triangular=True`` produces the low-memory layout: row j holds the
    strictly-upper entries (j, right), diagonal excluded (magenpy
    load(return_symmetric=False) semantics).
    """
    m = R.shape[0]
    data, indptr, left = [], [0], []
    for j in range(m):
        nz = np.nonzero(R[j])[0]
        if len(nz) == 0:
            lo, hi = j, j + 1
        else:
            lo, hi = int(nz.min()), int(nz.max()) + 1
        if triangular:
            lo = j + 1
            hi = max(hi, j + 1)
        row = R[j, lo:hi]
        data.extend(row)
        indptr.append(len(data))
        left.append(lo)
    arr = np.asarray(data)
    if dtype == np.int8:
        arr = np.clip(np.rint(arr * 127.0), -127, 127).astype(np.int8)
    else:
        arr = arr.astype(dtype)
    return (np.ascontiguousarray(arr),
            np.asarray(indptr, np.int64),
            np.asarray(left, np.int32))


class RefKernel:
    """Convenience wrapper running the compiled reference kernels with the
    reference Python driver's exact precomputation (VIPRS.py:381-424)."""

    def __init__(self):
        self.lib = build_ref_kernel()

    def e_step(self, banded, std_beta, n_per_snp, gamma, mu, eta, q,
               sigma_eps, tau_beta, pi, lambda_min=0.0, dq_scale=1.0,
               low_memory=False):
        """One in-place sweep. banded = (data, indptr, left)."""
        data, indptr, left = banded
        m = len(std_beta)
        var_tau = n_per_snp * (1.0 + lambda_min) / sigma_eps + tau_beta
        mu_mult = np.ascontiguousarray(n_per_snp / (var_tau * sigma_eps))
        u_logs = np.ascontiguousarray(
            np.log(pi) - np.log(1.0 - pi)
            + 0.5 * (np.log(tau_beta) - np.log(var_tau)))
        shvt = np.ascontiguousarray(np.sqrt(0.5 * var_tau))
        eta_diff = np.zeros(m)
        fn = self.lib.ref_e_step_i8 if data.dtype == np.int8 \
            else self.lib.ref_e_step_f64
        fn(m, left, indptr, data, std_beta, gamma, mu, eta, q, eta_diff,
           u_logs, shvt, mu_mult, dq_scale, 1, low_memory)
        return var_tau, eta_diff

    def e_step_mixture(self, banded, std_beta, n_per_snp, gamma, mu, eta, q,
                       sigma_eps, tau_beta, pi, lambda_min=0.0, dq_scale=1.0,
                       low_memory=False):
        """One in-place mixture sweep. gamma/mu: (M, K) C-order."""
        data, indptr, left = banded
        m, K = gamma.shape
        var_tau = np.ascontiguousarray(
            n_per_snp[:, None] * (1.0 + lambda_min) / sigma_eps
            + tau_beta[None, :])
        mu_mult = np.ascontiguousarray(n_per_snp[:, None] / (var_tau * sigma_eps))
        u_logs = np.ascontiguousarray(
            (np.log(pi) - np.log(1.0 - pi))[None, :]
            + 0.5 * (np.log(tau_beta)[None, :] - np.log(var_tau)))
        shvt = np.ascontiguousarray(np.sqrt(0.5 * var_tau))
        log_null_pi = np.full(m, np.log(1.0 - pi.sum()))
        eta_diff = np.zeros(m)
        self.lib.ref_e_step_mixture_f64(
            m, K, left, indptr, data, std_beta,
            np.ascontiguousarray(gamma).reshape(-1),
            np.ascontiguousarray(mu).reshape(-1), eta, q, eta_diff,
            log_null_pi, u_logs.reshape(-1), shvt.reshape(-1),
            mu_mult.reshape(-1), dq_scale, 1, low_memory)
        return var_tau, eta_diff

    def e_step_grid(self, banded, std_beta, n_per_snp, gamma, mu, eta, q,
                    sigma_eps, tau_beta, pi, active_idx=None, lambda_min=0.0,
                    dq_scale=1.0, low_memory=False):
        """One in-place grid sweep. gamma/mu/eta/q: (M, S) F-order
        (the reference's column-major (M, n_models) layout); sigma_eps/
        tau_beta/pi/lambda_min: (S,) vectors."""
        data, indptr, left = banded
        m, S = gamma.shape
        if active_idx is None:
            active_idx = np.arange(S, dtype=np.int32)
        active_idx = np.ascontiguousarray(active_idx, dtype=np.int32)
        var_tau = n_per_snp[:, None] * (1.0 + lambda_min)[None, :] / \
            sigma_eps[None, :] + tau_beta[None, :]
        mu_mult = n_per_snp[:, None] / (var_tau * sigma_eps[None, :])
        u_logs = (np.log(pi) - np.log(1.0 - pi))[None, :] \
            + 0.5 * (np.log(tau_beta)[None, :] - np.log(var_tau))
        eta_diff = np.zeros((m, S))

        def F(x):
            return np.asfortranarray(x).reshape(-1, order='F').copy()

        g_f, m_f, e_f, q_f, d_f = F(gamma), F(mu), F(eta), F(q), F(eta_diff)
        self.lib.ref_e_step_grid_f64(
            m, len(active_idx), active_idx, left, indptr, data, std_beta,
            g_f, m_f, e_f, q_f, d_f, F(u_logs), F(0.5 * var_tau), F(mu_mult),
            dq_scale, 1, low_memory)
        out = [x.reshape(m, S, order='F') for x in (g_f, m_f, e_f, q_f, d_f)]
        gamma[:], mu[:], eta[:], q[:] = out[:4]
        return var_tau, out[4]
