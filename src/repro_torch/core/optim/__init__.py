"""``repro_torch.core.optim`` — one stateful optimiser API.  Port of
``repro.core.optim``:

    opt   = get_optimizer("nghf", forward_fn, loss_spec, cg_iters=8)
    state = opt.init(params)
    params, state, metrics = opt.step(params, state, grad_batch, cg_batch)

Registry names: "sgd", "adam" (first-order, ignore ``cg_batch``) and
"ng", "hf", "nghf" (two-stage second-order, require it).
"""
from repro_torch.core.optim.base import (OPTIMIZERS, Optimizer, config_for,
                                         get_optimizer, list_optimizers,
                                         register_optimizer)
from repro_torch.core.optim.first_order import (SGD, Adam, AdamConfig,
                                                SGDConfig)
from repro_torch.core.optim.preconditioners import (
    PRECONDITIONERS, FisherDiagPreconditioner, IdentityPreconditioner,
    Preconditioner, ShareCountsPreconditioner, get_preconditioner)
from repro_torch.core.optim.second_order import (SecondOrderConfig,
                                                 SecondOrderOptimizer)

__all__ = [
    "OPTIMIZERS", "Optimizer", "config_for", "get_optimizer",
    "list_optimizers", "register_optimizer",
    "SGD", "Adam", "AdamConfig", "SGDConfig",
    "PRECONDITIONERS", "Preconditioner", "IdentityPreconditioner",
    "ShareCountsPreconditioner", "FisherDiagPreconditioner",
    "get_preconditioner",
    "SecondOrderConfig", "SecondOrderOptimizer",
]
