from .samplers import (
    ErrorBoundSamplerConfig,
    UniformSamplerConfig,
    error_bound_z_vals,
    sample_pdf,
    uniform_z_vals,
)
