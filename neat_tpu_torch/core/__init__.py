from .embedder import positional_encoding, encoding_dim
from .density import LaplaceDensity, laplace_density, get_beta
from .camera import lift, get_camera_params, project2d, get_sphere_intersections, psnr, load_k_rt_from_p
from .render import alpha_transmittance, render_weights_from_density
