"""Shi–Tomasi corner selection (PyTorch): counterpart of
``lk_tpu.features``, with its exports."""

from lk_tpu_torch.features.shi_tomasi import (  # noqa: F401
    good_features_from_response,
    good_features_to_track,
    min_eig_response,
)
