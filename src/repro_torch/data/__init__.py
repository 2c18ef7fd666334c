from repro_torch.data.synthetic import (
    DATASETS,
    airquality_like,
    extrasensory_like,
    extrasensory_multilabel_like,
    fitrec_like,
    fmnist_like,
)
from repro_torch.data.partition import (dirichlet_partition,
                                        label_sorted_partition)
from repro_torch.data.lm import (batches_from_tokens,
                                 federated_token_clients,
                                 synthetic_token_stream)

__all__ = [
    "airquality_like",
    "extrasensory_like",
    "extrasensory_multilabel_like",
    "fitrec_like",
    "fmnist_like",
    "DATASETS",
    "dirichlet_partition",
    "label_sorted_partition",
    "synthetic_token_stream",
    "federated_token_clients",
    "batches_from_tokens",
]
