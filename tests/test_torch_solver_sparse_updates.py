"""Data updates and a warm start on the sparse multifrontal path of
clarabel_tpu_torch against the JAX package's, both on the CPU
(test_torch_solver_sparse.py's box QP without presolve, as
tests/test_multifrontal.py updates it): after each update of q, P, A and b,
and a warm re-solve, the same status and the parity contract of
tests/_torch_parity.py; the warm start saves iterations; a change of A's
sparsity raises.  A file of one test (its JAX multifrontal compiles), which
pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from test_torch_solver_sparse import MF, _box_qp


def test_data_updates_and_warm_start():
    P, q, A, b = _box_qp()
    n = q.size
    solvers = {}
    for pkg in (ct, tt):
        settings = pkg.DefaultSettings(verbose=False, direct_solve_method=MF,
                                       presolve_enable=False)
        kw = dict(device="cpu") if pkg is tt else {}
        solvers[pkg] = pkg.DefaultSolver(P, q, A, b, [pkg.NonnegativeConeT(2 * n),
                                                      pkg.ZeroConeT(1)], settings, **kw)
    P_up = sp.triu(P, format="csc")
    updates = [
        lambda s: s.update_q((np.arange(5), np.full(5, 0.3))),
        lambda s: s.update_P(P_up.data * 1.01),
        lambda s: s.update_A(A * 1.02),
        lambda s: s.update_b((np.array([2 * n]), np.array([0.8]))),
    ]
    lanes = {pkg: [] for pkg in solvers}
    for pkg, s in solvers.items():
        first = s.solve()
        lanes[pkg].append(tp.lane_of(s))
        for up in updates:
            up(s)
            s.solve()
            lanes[pkg].append(tp.lane_of(s))
        s.update_q(q * 1.01)
        s.solve(warm_start=first)
        lanes[pkg].append(tp.lane_of(s))
    for r, g in zip(lanes[ct], lanes[tt]):
        assert g.status == tt.SolverStatus.Solved
        tp.assert_lane_matches(r, g, [r, r], [g, g])
    # the warm start saves iterations over the cold first solve
    assert lanes[tt][-1].iterations < lanes[tt][0].iterations
    with pytest.raises(ValueError, match="identical sparsity"):
        solvers[tt].update_A(sp.eye(A.shape[0], n, format="csc"))
