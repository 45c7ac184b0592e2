from geoformer_tpu_torch.geometry.homography import (  # noqa: F401
    warp_points,
    compute_valid_mask,
    sample_homography,
    scale_homography,
    corner_error,
)
from geoformer_tpu_torch.geometry.ransac import (  # noqa: F401
    dlt_homography,
    ransac_homography,
)
