"""The Goemans-Williamson max-cut SDP relaxation in primal form.

Frozen copy of ``random_graph_laplacian`` and ``maxcut_primal`` from the
port's ``chip_smoke.py``, with A and P built sparse (CSC, the form users
pass a large program in):

    minimize ⟨−L/4, X⟩  subject to  diag(X) = 1,  X ⪰ 0,

over one random graph of ``vertices`` vertices and ``edges`` unit-weight
edges, drawn from the configuration's ``graph_seed`` (SDPLIB's mcp100 has
order 100 and is one fixed graph; its own graph is a data file and is not
used).  Each instance relabels the graph's vertices by a permutation drawn
from the run's seed: the data of every call differ, the work does not.
x = svec(X): one ``PSDTriangleConeT`` on s = x and one ``ZeroConeT`` on the
diagonal.  Every entry of X is a variable, so no
chordal decomposition applies.
"""

import numpy as np
import scipy.sparse as sp


def svec_index(order: int):
    """(rows, cols, scale) of svec's entries: the upper triangle column by
    column, off-diagonal entries times √2."""
    rows, cols = np.triu_indices(order)
    keep = np.lexsort((rows, cols))  # column-major: sort by column, then row
    rows, cols = rows[keep], cols[keep]
    scale = np.where(rows == cols, 1.0, np.sqrt(2.0))
    return rows, cols, scale


def svec(X: np.ndarray) -> np.ndarray:
    rows, cols, scale = svec_index(X.shape[-1])
    return X[..., rows, cols] * scale


def random_graph_laplacian(order: int, edges: int, rng: np.random.Generator) -> np.ndarray:
    pairs = np.array([(i, j) for j in range(order) for i in range(j)])
    pick = pairs[rng.choice(len(pairs), size=edges, replace=False)]
    W = np.zeros((order, order))
    W[pick[:, 0], pick[:, 1]] = W[pick[:, 1], pick[:, 0]] = 1.0
    return np.diag(W.sum(axis=1)) - W


def make(config: dict, lanes, rng: np.random.Generator) -> dict:
    if lanes is not None:
        raise ValueError("the max-cut generator makes one problem a call")
    order = config["vertices"]
    L = random_graph_laplacian(order, config["edges"],
                               np.random.default_rng(config["graph_seed"]))
    perm = rng.permutation(order)
    L = L[np.ix_(perm, perm)]
    tri = order * (order + 1) // 2
    diag = np.array([j * (j + 1) // 2 + j for j in range(order)])
    A_eq = sp.csc_matrix((np.ones(order), (np.arange(order), diag)), shape=(order, tri))
    A = sp.vstack([-sp.eye(tri, format="csc"), A_eq], format="csc")
    b = np.concatenate([np.zeros(tri), np.ones(order)])
    return dict(P=sp.csc_matrix((tri, tri)), q=svec(-L / 4.0), A=A, b=b,
                cones=[["PSDTriangleConeT", [order]], ["ZeroConeT", [order]]])
