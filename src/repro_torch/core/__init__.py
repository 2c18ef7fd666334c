"""Federated core of the port: async server (Eq. 4), feature learning
(Eq. 5-6), online client update (Eq. 7-11), metrics, and the algorithm
strategies (``repro_torch.core.algorithms``) that plug into the cohort
engine in ``repro_torch.sim``; ``run`` is the façade over all of them."""
from repro_torch.core.client import (
    ClientState,
    client_step,
    dynamic_multiplier,
    init_client_state,
    receive_server_model,
    surrogate_grad,
)
from repro_torch.core.feature_learning import (apply_feature_learning,
                                               first_layer_path)
from repro_torch.core.federated import (
    ALGORITHMS,
    DeviceProfile,
    HistoryPoint,
    RunConfig,
    SimClient,
    make_sim_clients,
    run,
)
from repro_torch.core.server import ServerState, aggregate, init_server
from repro_torch.sim.streaming import OnlineStream

__all__ = [
    "ClientState",
    "client_step",
    "dynamic_multiplier",
    "init_client_state",
    "receive_server_model",
    "surrogate_grad",
    "apply_feature_learning",
    "first_layer_path",
    "ALGORITHMS",
    "DeviceProfile",
    "HistoryPoint",
    "RunConfig",
    "SimClient",
    "make_sim_clients",
    "run",
    "ServerState",
    "aggregate",
    "init_server",
    "OnlineStream",
]
