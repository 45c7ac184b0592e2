from geoformer_tpu_torch.models.geoformer import GeoFormer, MatchOutput  # noqa: F401
