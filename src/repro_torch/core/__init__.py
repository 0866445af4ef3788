"""DMTRL core in PyTorch: the Algorithm-1 trainer and its estimator facade.

    from repro_torch.core import DMTRLEstimator
    est = DMTRLEstimator(loss="hinge", solver="pallas_round")   # on the card
    est.fit(train).score(test)
"""
from .dmtrl import (
    DMTRLConfig,
    DMTRLResult,
    WarmStart,
    fit,
    make_w_step_round,
    resolve_device,
    w_step,
)
from .engines import (
    Engine,
    EngineResult,
    available_engines,
    get_engine,
    register_engine,
)
from .estimator import DMTRLEstimator, NotFittedError
from .losses import Loss, get_loss, registered_losses
from .mtl_data import MTLData, from_task_list, normalize_rows
from .omega import (
    correlation_from_sigma,
    init_sigma,
    omega_step,
    omega_step_lowrank,
    rho_lemma10,
    rho_spectral,
)
from .omega_regularizers import (
    OmegaRegularizer,
    available_regularizers,
    get_regularizer,
    register_regularizer,
    resolve_regularizer,
)
from .sigma_view import (
    DenseSigma,
    LowRankDiagSigma,
    SigmaView,
    SparseSigma,
    as_view,
    maybe_dense,
    view_from_factors,
)
from .solver_backends import (
    SolverBackend,
    available_backends,
    get_backend,
    register_backend,
)
