from kaolin_tpu_torch.render.lighting.sg import (  # noqa: F401
    SgLightingParameters,
    approximate_sg_integral,
    cosine_lobe_sg,
    fresnel,
    sg_diffuse_fitted,
    sg_diffuse_inner_product,
    sg_direction_from_azimuth_elevation,
    sg_distribution_term,
    sg_from_sun,
    sg_irradiance_fitted,
    sg_irradiance_inner_product,
    sg_warp_distribution,
    sg_warp_specular_term,
    unbatched_reduced_sg_inner_product,
    unbatched_sg_inner_product,
)
from kaolin_tpu_torch.render.lighting.sh import (  # noqa: F401
    project_onto_sh9,
    sh9_diffuse,
    sh9_irradiance,
)
