"""fit_mfu: a fit's floating-point operations, counted from the shapes
stage by stage as Algorithm 1 needs them, over ``fit_s`` times the H100's
float32 peak (the fit runs with TF32 off), in percent.

Per fit, with m tasks, d features, N real training rows, H steps a round,
P outer iterations of T rounds and E tracked objective evaluations, for
the paper's Omega-step (``trace_constraint``, a dense Sigma):
  * local SDCA: 4 m H d a round (two dot products and an axpy a step);
  * the server reduce W += Sigma dB / lambda a round: 2 m^2 d;
  * each tracked evaluation of the dual and primal: B = X^T alpha / n
    (2 N d), Sigma B (as the reduce), tr(Sigma B^T B) (2 m d) and the
    predictions X W (2 N d); recomputations of B or Sigma B inside one
    evaluation are not counted;
  * after each Omega-step, W(alpha) = Sigma B / lambda: 2 N d + Sigma B;
  * the Omega-step: W W^T (2 m^2 d), the symmetric eigendecomposition at
    9 m^3 (Golub and Van Loan's count for the symmetric QR algorithm with
    eigenvectors; cuSOLVER's divide and conquer does about as much), and
    V diag(s) V^T (2 m^3); the precision Omega is not counted (the W-step
    never reads it);
  * Lemma 10's rho before each W-step: the row sums of |Sigma| (2 m^2).
The count is the benchmark's own, frozen here; the port's counter
(``roofline/analysis.py`` ``CostCounter`` at commit 80b0bbf) counts what its
code launches, recomputations included. Another Omega-step has no count
here, and the reader returns nothing for it.
"""
from perfbench import peaks


def fit_flops(sh: dict) -> float:
    m, d, N, H = sh["m"], sh["d"], sh["n_total"], sh["H"]
    P, T, E = sh["outer_iters"], sh["rounds"], sh["tracked"]
    sigma_b = 2.0 * m * m * d
    per_round = 4.0 * m * H * d + sigma_b
    per_eval = 4.0 * N * d + sigma_b + 2.0 * m * d
    w_alpha = 2.0 * N * d + sigma_b
    omega = 2.0 * m * m * d + 9.0 * m**3 + 2.0 * m**3
    rho = 2.0 * m * m
    return P * (T * per_round + w_alpha + omega + rho) + E * per_eval


def read(record):
    fit_s = record.get("fit_s")
    sh = record.get("shapes")
    if not fit_s or not sh or sh.get("member") != "trace_constraint":
        return None
    return 100.0 * fit_flops(sh) / (fit_s * peaks.FP32_FLOPS)
