from repro_torch.data.synthetic import (
    DATASETS,
    airquality_like,
    extrasensory_like,
    extrasensory_multilabel_like,
    fitrec_like,
    fmnist_like,
)

__all__ = [
    "airquality_like",
    "extrasensory_like",
    "extrasensory_multilabel_like",
    "fitrec_like",
    "fmnist_like",
    "DATASETS",
]
