"""Markowitz long-only portfolio QPs with a factor covariance: the Portfolio
class of the OSQP benchmark suite (Stellato et al., Math. Prog. Comp. 12,
2020, appendix A; ``problem_classes/portfolio.py`` of
github.com/osqp/osqp_benchmarks), solved as a scenario batch.

The class has n = 100·k assets and k factors.  It draws F (n × k) with half
of its entries nonzero, each N(0, 1); the diagonal D uniform on [0, √k);
the expected returns μ N(0, 1); γ = 1.  It states the problem with the
factor exposures y = Fᵀx as variables:

    minimize xᵀDx + yᵀy − μᵀx/γ  subject to  1ᵀx = 1,  Fᵀx = y,  0 ≤ x ≤ 1.

This generator eliminates y and drops x ≤ 1, which 1ᵀx = 1 and x ≥ 0
imply, so each lane is the same problem in x alone:

    minimize ½ xᵀPx − μᵀx/γ  with  P = 2(D + F Fᵀ),  subject to  1ᵀx = 1,  x ≥ 0,

one ``ZeroConeT`` row and n ``NonnegativeConeT`` rows.  A call is a batch
of lanes: one covariance, and each lane its own draw of μ, as a user who
solves one covariance under many scenarios of the returns sends it.

The draws are made once, from the configuration's ``data_seed``: F, D and
the μ of every lane.  Each instance relabels them from the run's seed, the
assets by one permutation and the lanes by another, so the data of every
call differ and the work does not (the number of iterations of a batch is
that of its slowest lane, which another set of draws would move).
"""

import numpy as np


def draws(config: dict, lanes: int, rng: np.random.Generator):
    """F, D and the lanes' μ, as the OSQP class draws them."""
    k = config["factors"]
    n = config["assets_per_factor"] * k
    # F as scipy.sparse.random(n, k, density, data_rvs=randn) draws it: the
    # nonzeros at distinct positions, their values N(0, 1)
    F = np.zeros(n * k)
    at = rng.choice(n * k, size=int(round(config["factor_density"] * n * k)), replace=False)
    F[at] = rng.standard_normal(at.size)
    F = F.reshape(k, n).T
    D = rng.uniform(0.0, 1.0, size=n) * np.sqrt(k)
    mu = rng.standard_normal(size=(lanes, n))
    return F, D, mu


def make(config: dict, lanes, rng: np.random.Generator) -> dict:
    if lanes is None:
        raise ValueError("the portfolio generator makes a batch of lanes a call")
    F, D, mu = draws(config, lanes, np.random.default_rng(config["data_seed"]))
    n = D.size
    assets, order = rng.permutation(n), rng.permutation(lanes)
    P = 2.0 * (np.diag(D) + F @ F.T)[np.ix_(assets, assets)]
    q = -mu[order][:, assets] / config["gamma"]
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    return dict(P=np.tile(P, (lanes, 1, 1)), q=q, A=np.tile(A, (lanes, 1, 1)),
                b=np.tile(b, (lanes, 1)), cones=[["ZeroConeT", [1]], ["NonnegativeConeT", [n]]])
