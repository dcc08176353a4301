"""Model library: likelihoods + parameter specs for the reference's example
and test models (SURVEY.md §2.11, §4) — linear regression, CAPM,
An-Schorfheide DSGE, and the regime-switching regression fixture. Every
likelihood is a pure, total JAX function of a flat f64[P] vector, written to
vmap into batched work across particles."""

from smc_jax.models.linear import (
    linear_parameters,
    make_linear_loglike,
    generate_linear_data,
    rs_linear_parameters,
    make_rs_linear_loglike,
    generate_rs_linear_data,
)
from smc_jax.models.regression import (
    regression_parameters,
    make_regression_loglike,
    generate_regression_data,
)
from smc_jax.models.capm import (
    capm_parameters,
    make_capm_loglike,
    generate_capm_data,
)
from smc_jax.models.dsge import (
    LinearDSGE,
    solve_linear_re,
    kalman_loglike,
    lyapunov_doubling,
)
from smc_jax.models.as_dsge import (
    an_schorfheide,
    an_schorfheide_parameters,
    generate_as_data,
    TRUE_PARAMS as AS_TRUE_PARAMS,
)
from smc_jax.models.sw_dsge import (
    smets_wouters,
    sw_parameters,
    generate_sw_data,
    TRUE_PARAMS as SW_TRUE_PARAMS,
)
