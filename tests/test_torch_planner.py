"""Every planner policy of the port's ring engine against the JAX
package's, with the kernel path forced (see ``torch_parity``)."""
import random

import pytest

torch = pytest.importorskip("torch")

from helpers import rand_expr_ast  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from torch_parity import (BINDINGS, check_eval,  # noqa: E402
                          check_eval_many, engines)


@pytest.mark.parametrize("policy", ["cost", "naive", "forward", "reverse",
                                    "split"])
def test_planner_policy_parity(policy):
    rnd = random.Random(7)
    g = rfix.random_graph(30, 3, 110, seed=4)
    ref, port = engines(g, planner=policy)
    exprs = ["0/1*", "(0|1)/2", "1/^2/0", "(0)/(2)/(1*)",
             str(rand_expr_ast(rnd, 2, 3))]
    for expr in exprs:
        for s, o in BINDINGS:
            check_eval(ref, port, g, expr, s, o)
    check_eval_many(ref, port, g, [(e, None, 3) for e in exprs]
                     + [(e, 5, None) for e in exprs])
