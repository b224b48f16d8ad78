"""Exact Riemann solver for the 1D Euler equations (ideal gas).

Test oracle for shocktube problems. The reference validates against
pre-tabulated exact solutions shipped as data files (e.g.
``extern/Toro/e1rpex.ini``); here the exact solution is computed directly
with the classical iterative star-state solver (Toro, "Riemann Solvers and
Numerical Methods for Fluid Dynamics", ch. 4) in plain NumPy.
"""

from __future__ import annotations

import numpy as np


def _pressure_function(p, rho_k, p_k, c_k, gamma):
    """f_k(p) and df_k/dp for one side (shock if p > p_k, rarefaction else)."""
    if p > p_k:  # shock
        A = 2.0 / ((gamma + 1.0) * rho_k)
        B = (gamma - 1.0) / (gamma + 1.0) * p_k
        sqrt_term = np.sqrt(A / (p + B))
        f = (p - p_k) * sqrt_term
        df = sqrt_term * (1.0 - 0.5 * (p - p_k) / (B + p))
    else:  # rarefaction
        f = (2.0 * c_k / (gamma - 1.0)) * ((p / p_k) ** ((gamma - 1.0) / (2.0 * gamma)) - 1.0)
        df = (1.0 / (rho_k * c_k)) * (p / p_k) ** (-(gamma + 1.0) / (2.0 * gamma))
    return f, df


def solve_star_state(rho_L, u_L, p_L, rho_R, u_R, p_R, gamma, tol=1e-12, max_iter=100):
    """Newton iteration for the star-region pressure and velocity."""
    c_L = np.sqrt(gamma * p_L / rho_L)
    c_R = np.sqrt(gamma * p_R / rho_R)
    du = u_R - u_L

    # initial guess: two-rarefaction approximation
    pv = 0.5 * (p_L + p_R) - 0.125 * du * (rho_L + rho_R) * (c_L + c_R)
    p = max(1e-14, pv)
    for _ in range(max_iter):
        f_L, df_L = _pressure_function(p, rho_L, p_L, c_L, gamma)
        f_R, df_R = _pressure_function(p, rho_R, p_R, c_R, gamma)
        f = f_L + f_R + du
        df = df_L + df_R
        dp = f / df
        p_new = max(1e-14, p - dp)
        if abs(p_new - p) < tol * 0.5 * (p_new + p):
            p = p_new
            break
        p = p_new
    f_L, _ = _pressure_function(p, rho_L, p_L, c_L, gamma)
    f_R, _ = _pressure_function(p, rho_R, p_R, c_R, gamma)
    u_star = 0.5 * (u_L + u_R) + 0.5 * (f_R - f_L)
    return p, u_star


def sample(xi, rho_L, u_L, p_L, rho_R, u_R, p_R, gamma):
    """Sample the self-similar solution at speeds xi = x/t.

    Returns (rho, u, p) arrays.
    """
    xi = np.asarray(xi, dtype=np.float64)
    c_L = np.sqrt(gamma * p_L / rho_L)
    c_R = np.sqrt(gamma * p_R / rho_R)
    p_s, u_s = solve_star_state(rho_L, u_L, p_L, rho_R, u_R, p_R, gamma)

    gm1, gp1 = gamma - 1.0, gamma + 1.0

    rho = np.empty_like(xi)
    u = np.empty_like(xi)
    p = np.empty_like(xi)

    for i, s in enumerate(xi):
        if s <= u_s:  # left of contact
            if p_s > p_L:  # left shock
                rho_sL = rho_L * ((p_s / p_L + gm1 / gp1) / (gm1 / gp1 * p_s / p_L + 1.0))
                S_L = u_L - c_L * np.sqrt(gp1 / (2 * gamma) * p_s / p_L + gm1 / (2 * gamma))
                if s < S_L:
                    rho[i], u[i], p[i] = rho_L, u_L, p_L
                else:
                    rho[i], u[i], p[i] = rho_sL, u_s, p_s
            else:  # left rarefaction
                rho_sL = rho_L * (p_s / p_L) ** (1.0 / gamma)
                c_sL = c_L * (p_s / p_L) ** (gm1 / (2 * gamma))
                head, tail = u_L - c_L, u_s - c_sL
                if s < head:
                    rho[i], u[i], p[i] = rho_L, u_L, p_L
                elif s > tail:
                    rho[i], u[i], p[i] = rho_sL, u_s, p_s
                else:  # inside fan
                    uf = 2.0 / gp1 * (c_L + gm1 / 2.0 * u_L + s)
                    cf = 2.0 / gp1 * (c_L + gm1 / 2.0 * (u_L - s))
                    rho[i] = rho_L * (cf / c_L) ** (2.0 / gm1)
                    u[i] = uf
                    p[i] = p_L * (cf / c_L) ** (2.0 * gamma / gm1)
        else:  # right of contact
            if p_s > p_R:  # right shock
                rho_sR = rho_R * ((p_s / p_R + gm1 / gp1) / (gm1 / gp1 * p_s / p_R + 1.0))
                S_R = u_R + c_R * np.sqrt(gp1 / (2 * gamma) * p_s / p_R + gm1 / (2 * gamma))
                if s > S_R:
                    rho[i], u[i], p[i] = rho_R, u_R, p_R
                else:
                    rho[i], u[i], p[i] = rho_sR, u_s, p_s
            else:  # right rarefaction
                rho_sR = rho_R * (p_s / p_R) ** (1.0 / gamma)
                c_sR = c_R * (p_s / p_R) ** (gm1 / (2 * gamma))
                head, tail = u_R + c_R, u_s + c_sR
                if s > head:
                    rho[i], u[i], p[i] = rho_R, u_R, p_R
                elif s < tail:
                    rho[i], u[i], p[i] = rho_sR, u_s, p_s
                else:
                    uf = 2.0 / gp1 * (-c_R + gm1 / 2.0 * u_R + s)
                    cf = 2.0 / gp1 * (c_R - gm1 / 2.0 * (u_R - s))
                    rho[i] = rho_R * (cf / c_R) ** (2.0 / gm1)
                    u[i] = uf
                    p[i] = p_R * (cf / c_R) ** (2.0 * gamma / gm1)
    return rho, u, p


def shocktube_exact(x, t, x0, left, right, gamma):
    """Exact (rho, u, p) at positions x, time t, diaphragm at x0.
    `left`/`right` = (rho, u, p) tuples."""
    x = np.asarray(x, dtype=np.float64)
    if t <= 0.0:
        rho = np.where(x < x0, left[0], right[0])
        u = np.where(x < x0, left[1], right[1])
        p = np.where(x < x0, left[2], right[2])
        return rho, u, p
    xi = (x - x0) / t
    return sample(xi, left[0], left[1], left[2], right[0], right[1], right[2], gamma)
