"""Plain reference of the paper's Algorithm 1 (Liu, Pan, Ho, KDD 2017).

P alternations of a W-step (T communication rounds of local SDCA over every
task, each followed by the server reduce W += Sigma dB / lambda) and an
Omega-step (Sigma from W, the paper's ``trace_constraint``), with the
Lemma-10 rho before every W-step and the primal and dual objectives at the
tracked rounds. Hinge loss only; ``job_from`` refuses a traffic mix that
asks for anything else.

It imports nothing of the program: it draws the coordinates with its own
copy of the threefry arithmetic (``threefry.py``), builds its own padded
arrays from the per-task arrays the harness made, and works out every
Sigma, rho and W again.

Precision: ``"float64"`` is the reference. ``"tf32"`` is the control, the
same arithmetic in float32 with the operands of every matrix product
rounded to TF32 (10 mantissa bits) first, which is what a TF32 tensor-core
product computes.

Layout of the work: the d-long products of a round (the gathered rows, q =
X w, every block's B x B Gram, X_b r and r += X_b^T delta) run on
``device`` in batched products; the B sequential coordinate steps of each
block run on the host in numpy over all tasks at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import threefry

Tensor = torch.Tensor


@dataclasses.dataclass
class Job:
    """What one fit does: hinge loss, the paper's Omega-step, one local
    epoch (ceil(n_max / block) blocks) a round."""

    lam: float
    outer_iters: int
    rounds: int
    block: int
    track_every: int
    eta: float = 1.0
    jitter: float = 1e-6


@dataclasses.dataclass
class Result:
    W: np.ndarray  # (m, d)
    alpha: np.ndarray  # (m, n_max)
    sigma: np.ndarray  # (m, m)
    rho: List[float]  # one per outer iteration
    dual: List[float]  # at the tracked rounds
    primal: List[float]
    scores: np.ndarray  # (m, n_test_max) held-out scores, 0 on padding


def pad(xs: List[np.ndarray], ys: List[np.ndarray], n_max: Optional[int] = None):
    """(X (m, n_max, d), Y (m, n_max), mask (m, n_max), n (m,)) from
    per-task arrays, zero-padded."""
    m, d = len(xs), xs[0].shape[1]
    ns = np.array([x.shape[0] for x in xs], np.int64)
    n_max = int(n_max or ns.max())
    X = np.zeros((m, n_max, d), np.float32)
    Y = np.zeros((m, n_max), np.float32)
    M = np.zeros((m, n_max), np.float32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        X[i, : len(x)] = x
        Y[i, : len(x)] = y
        M[i, : len(x)] = 1.0
    return X, Y, M, ns


def tf32(t: Tensor) -> Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    bits = t.contiguous().view(torch.int32)
    bits = bits + 0xFFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


class _Arith:
    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision is float64 or tf32, got {precision!r}")
        self.lowered = precision == "tf32"
        self.dtype = torch.float32 if self.lowered else torch.float64
        self.np = np.float32 if self.lowered else np.float64

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        """a @ b (batched where the operands are)."""
        if self.lowered:
            return tf32(a) @ tf32(b)
        return a @ b


def _lemma10(S: Tensor, eta: float) -> float:
    """eta * max_i sum_j |Sigma_ij| / Sigma_ii (the paper's Lemma 10)."""
    dd = torch.clamp(torch.diagonal(S), min=1e-30)
    return float(eta * torch.max(torch.sum(torch.abs(S), dim=1) / dd))


def _omega_trace(W: Tensor, ar: _Arith, jitter: float) -> Tensor:
    """Zhang-Yeung: Sigma = (W W^T)^(1/2) / tr, jittered, trace 1."""
    m = W.shape[0]
    M = ar.mm(W, W.T)
    ev, V = torch.linalg.eigh(0.5 * (M + M.T))
    s = torch.sqrt(torch.clamp(ev, min=0.0))
    tr = torch.sum(s)
    s = s / tr if float(tr) > 1e-30 else torch.full_like(s, 1.0 / m)
    s = s + jitter
    s = s / torch.sum(s)
    S = ar.mm(V * s, V.T)
    return 0.5 * (S + S.T)


class Problem:
    """The padded training and held-out arrays on ``device``."""

    def __init__(self, xtr, ytr, xte, yte, device, ar: _Arith):
        X, Y, M, n = pad(xtr, ytr)
        Xt, _, Mt, _ = pad(xte, yte)
        self.m, self.n_max, self.d = X.shape
        self.n_np = n
        self.X = torch.as_tensor(X, device=device).to(ar.dtype)
        self.Y = torch.as_tensor(Y, device=device).to(ar.dtype)
        self.M = torch.as_tensor(M, device=device).to(ar.dtype)
        self.n = torch.as_tensor(n, device=device).to(ar.dtype)
        self.Xt = torch.as_tensor(Xt, device=device).to(ar.dtype)
        self.Mt = torch.as_tensor(Mt, device=device).to(ar.dtype)


def _coords(rkey: np.ndarray, m: int, H: int, n: np.ndarray) -> np.ndarray:
    """Each task's H coordinates of one round: min(int(u * n_i), n_i - 1),
    the product rounded to float32."""
    keys = threefry.fold_in(threefry.fold_in(rkey, np.arange(m)), 0)
    u = threefry.uniform(keys, (H,))
    j = (u * n.astype(np.float32)[:, None]).astype(np.int32)
    return np.minimum(j, (n - 1)[:, None].astype(np.int32)).astype(np.int64)


def _steps_host(CA, KDb, inva, yb, B: int):
    """The B steps of one block over every task, numpy. ``CA`` (m, 2B)
    holds each step's margin, then its dual value; step k pushes its delta
    into both through row k of ``KDb`` (B, m, 2B)."""
    deltas = np.empty((CA.shape[0], B), CA.dtype)
    buf = np.empty_like(CA)
    for k in range(B):
        yk, atk = yb[:, k], CA[:, B + k]
        t = yk - CA[:, k]
        t *= inva[:, k]
        t += atk
        t *= yk
        np.maximum(t, 0.0, out=t)
        np.minimum(t, 1.0, out=t)
        t *= yk
        dk = np.subtract(t, atk, out=deltas[:, k])
        np.multiply(KDb[k], dk[:, None], out=buf)
        CA += buf
    return deltas


def _local_round(pb: Problem, alpha: Tensor, W: Tensor, coords: np.ndarray,
                 kappa: np.ndarray, B: int, ar: _Arith):
    """One local SDCA round of every task (hinge): H coordinate steps each,
    in blocks of B. Returns (dalpha (m, n_max), r = X^T dalpha (m, d)).

    Step k of a block needs its margin c_k = q_k + kappa (x_k . r), r the
    sum of the earlier steps' delta x, and its dual value alpha_j +
    dalpha_j. Within a block both are pushed forward: step k adds kappa
    G[k, s] delta_k to every margin s and delta_k to every later step s that
    draws the same coordinate (the mask D[k, s])."""
    m, H = coords.shape
    nb, dev = H // B, W.device
    ct = torch.as_tensor(coords, device=dev)
    tids = torch.arange(m, device=dev)[:, None]
    Xs = pb.X[tids, ct]  # (m, H, d)
    q = ar.mm(Xs, W[:, :, None])[..., 0]  # (m, H)
    Xb = Xs.view(m, nb, B, pb.d)
    G = ar.mm(Xb, Xb.transpose(-1, -2))  # (m, nb, B, B)
    kap = torch.as_tensor(kappa, device=dev).to(G.dtype)
    cb = ct.view(m, nb, B)
    later = torch.ones((B, B), dtype=torch.bool, device=dev).triu(1)
    D = (cb[..., :, None] == cb[..., None, :]) & later
    KD = torch.cat([kap[:, None, None, None] * G, D.to(G.dtype)], dim=-1)
    KD = KD.permute(1, 2, 0, 3).contiguous()  # (nb, B, m, 2B)
    inva = 1.0 / torch.clamp(kap[:, None, None] * torch.diagonal(G, dim1=-2, dim2=-1), min=1e-12)
    KD, inva, q, Y = (t.cpu().numpy() for t in (KD, inva, q, pb.Y[tids, ct]))
    alpha_h, dalpha = alpha.cpu().numpy(), np.zeros(tuple(alpha.shape), KD.dtype)
    tids_h = np.arange(m)[:, None]
    r = torch.zeros_like(W)
    for b in range(nb):
        sl = slice(b * B, (b + 1) * B)
        xr = ar.mm(Xs[:, sl], r[:, :, None])[..., 0]
        cbh = coords[:, sl]
        CA = np.concatenate([q[:, sl] + kappa[:, None] * xr.cpu().numpy(),
                             alpha_h[tids_h, cbh] + dalpha[tids_h, cbh]], axis=1)
        deltas = _steps_host(CA, KD[b], inva[:, b], Y[:, sl], B)
        np.add.at(dalpha, (np.broadcast_to(tids_h, cbh.shape), cbh), deltas)
        dt = torch.as_tensor(deltas, device=dev)
        r = r + ar.mm(Xs[:, sl].transpose(1, 2), dt[:, :, None])[..., 0]
    return torch.as_tensor(dalpha, device=dev), r


def _objectives(pb: Problem, alpha: Tensor, sigma: Tensor, lam: float, ar: _Arith):
    """(dual, primal) of Eq. (2) and Eq. (1) at W(alpha), hinge."""
    Bm = torch.einsum("mnd,mn->md", pb.X, alpha * pb.M) / pb.n[:, None]  # b_i rows
    SB = ar.mm(sigma, Bm)
    quad = torch.sum(Bm * SB)  # tr(Sigma B^T B)
    conj = torch.sum((-alpha * pb.Y) * pb.M / pb.n[:, None])
    dual = -quad / (2.0 * lam) - conj
    W = SB / lam
    z = torch.einsum("mnd,md->mn", pb.X, W)
    risk = torch.sum(torch.clamp(1.0 - pb.Y * z, min=0.0) * pb.M / pb.n[:, None])
    return float(dual), float(risk + quad / (2.0 * lam))


def _w_of_alpha(pb: Problem, alpha: Tensor, sigma: Tensor, lam: float, ar: _Arith) -> Tensor:
    Bm = torch.einsum("mnd,mn->md", pb.X, alpha * pb.M) / pb.n[:, None]
    return ar.mm(sigma, Bm) / lam


def fit(xtr, ytr, xte, yte, job: Job, seed: int, device="cpu",
        precision: str = "float64") -> Result:
    """Algorithm 1 from alpha = 0, W = 0, Sigma = I/m."""
    ar = _Arith(precision)
    pb = Problem(xtr, ytr, xte, yte, torch.device(device), ar)
    m, n_max, d = pb.m, pb.n_max, pb.d
    dev = pb.X.device
    H = int(math.ceil(n_max / job.block)) * job.block
    alpha = torch.zeros((m, n_max), dtype=ar.dtype, device=dev)
    W = torch.zeros((m, d), dtype=ar.dtype, device=dev)
    sigma = torch.eye(m, dtype=ar.dtype, device=dev) / m
    n_safe = np.maximum(pb.n_np, 1)
    key = threefry.key(seed)
    rhos: List[float] = []
    duals: List[float] = []
    primals: List[float] = []
    for _ in range(job.outer_iters):
        rho = _lemma10(sigma, job.eta)
        rhos.append(rho)
        pair = threefry.split(key)
        key, sub = pair[0], pair[1]
        round_keys = threefry.split(sub, job.rounds)
        for t in range(job.rounds):
            coords = _coords(round_keys[t], m, H, pb.n_np)
            kappa = (rho * torch.diagonal(sigma).cpu().numpy() / (job.lam * n_safe)).astype(ar.np)
            dalpha, r = _local_round(pb, alpha, W, coords, kappa, job.block, ar)
            alpha = alpha + job.eta * dalpha
            db = job.eta * r / pb.n[:, None]
            W = W + ar.mm(sigma, db) / job.lam
            if t % job.track_every == 0 or t == job.rounds - 1:
                dd, pp = _objectives(pb, alpha, sigma, job.lam, ar)
                duals.append(dd)
                primals.append(pp)
        sigma = _omega_trace(W, ar, job.jitter)
        W = _w_of_alpha(pb, alpha, sigma, job.lam, ar)
    scores = torch.einsum("mnd,md->mn", pb.Xt, W) * pb.Mt
    return Result(
        W=W.double().cpu().numpy(), alpha=alpha.double().cpu().numpy(),
        sigma=sigma.double().cpu().numpy(), rho=rhos, dual=duals,
        primal=primals, scores=scores.double().cpu().numpy(),
    )


# what a traffic mix may ask for, and the values the reference implements;
# ``solver`` and ``block_size`` pick how the program computes the same round
TRAFFIC = {"name": None, "what": None, "engine": ("reference",), "loss": ("hinge",),
           "solver": None, "block_size": None, "local_iters": (0,), "outer_iters": None,
           "rounds": None, "track_every": None, "omega": None}
OMEGA = {"member": ("trace_constraint",), "params": ({},)}


def job_from(traffic: Dict, config: Dict) -> Job:
    """The reference's Job from a traffic mix and a configuration file.
    Raises ValueError for a key or a value the reference does not
    implement, so that a new traffic mix is never judged against other
    semantics than its own."""
    om = traffic.get("omega") or {}
    for where, got, allowed in (("traffic", traffic, TRAFFIC), ("omega", om, OMEGA)):
        for k, v in got.items():
            if k not in allowed:
                raise ValueError(f"the reference knows no {where} key {k!r}")
            if allowed[k] is not None and v not in allowed[k]:
                raise ValueError(f"the reference implements {where} {k} in {allowed[k]}, "
                                 f"not {v!r}")
    return Job(
        lam=float(config["lam"]), outer_iters=int(traffic["outer_iters"]),
        rounds=int(traffic["rounds"]), block=int(traffic["block_size"]),
        track_every=int(traffic["track_every"]),
    )
