"""Serving bundles of the matcher (torch.export), loadable without model
code: ``save_bundle`` writes one, ``load_bundle`` runs it."""

from geoformer_tpu_torch.serving.export import (  # noqa: F401
    ServingMatcher,
    export_matcher,
    load_bundle,
    save_bundle,
)
