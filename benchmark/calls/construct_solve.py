"""A user's call of one instance: build the solver through the public entry
on the instance, in the form users pass it, then ``.solve()``, which brings
the solution to the host."""

import time


def make(program):
    def call(inst: dict, mark):
        t0 = time.perf_counter()
        with mark("bench.construct"):
            solver = program.entry(inst["P"], inst["q"], inst["A"], inst["b"],
                                   program.cones(inst), program.settings(), **program.kwargs)
        t1 = time.perf_counter()
        with mark("bench.solve"):
            sol = solver.solve()
        return t1 - t0, time.perf_counter() - t1, sol

    return call
