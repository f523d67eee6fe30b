"""Determinism soak on the GPU: the fused kernel and the scan path must
produce bit-identical states across repeated same-seed runs.

A missing barrier between a tile's store and its re-read in the fused
kernel (ops/fused_pallas.py) shows up as run-to-run nondeterminism long
before it corrupts a verdict, and interpret mode cannot catch it. The
scan path's ``segment_sum`` accumulator is a float scatter-add, whose
summation order a GPU may vary; this soak reports whether it does.

    python tools/determinism_soak.py [repeats]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

from odesat_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state
from odesat_tpu.models.stoch import init_stoch_state, make_stoch_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat
from odesat_tpu.utils.timing import sync

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def run_repeats(name, make_state, runner, repeats, fields):
    ref = None
    for r in range(repeats):
        state = make_state()
        out = runner(state)
        sync(out)
        snap = {f: np.asarray(getattr(out, f)).copy() for f in fields}
        if ref is None:
            ref = snap
        else:
            for f in fields:
                if not np.array_equal(ref[f], snap[f]):
                    diff = np.abs(ref[f].astype(np.float64) - snap[f].astype(np.float64))
                    print(f"FAIL {name}: field {f} differs at repeat {r} "
                          f"(max {diff.max():.3e})")
                    return False
    print(f"OK   {name}: {repeats} repeats bit-identical")
    return True


def main():
    args = [a for a in sys.argv[1:] if a != "--quick"]
    quick = len(args) < len(sys.argv) - 1
    repeats = int(args[0]) if args else (2 if quick else 4)
    ok = True

    formula = parse_dimacs_file(os.path.join(HERE, "tests", "data", "hard.cnf"))
    _, aim = normalize_cnf_variables(formula)
    fa_aim = compile_formula(aim)
    dev_aim = formula_device(fa_aim)

    big = random_ksat(900, 3870, k=3, seed=5, planted=True)
    _, bignorm = normalize_cnf_variables(big)
    fa_big = compile_formula(bignorm, bucket=True)
    dev_big = formula_device(fa_big)

    from odesat_tpu.models.ode import make_chunk_runner, make_multi_chunk_runner
    from odesat_tpu.ops.fused_pallas import make_fused_chunk

    fields = ("v", "xs", "xl", "dt", "done")
    for mode, kwargs in (("fixed", dict(step_size=0.01)), (
            "adaptive", dict(tolerance=1e-3))):
        for mm in ("float32", "bfloat16"):
            ode = ODEConfig(matmul_dtype=mm, **kwargs)
            fn = make_fused_chunk(fa_aim, 0.001, ode, 2000)
            ok &= run_repeats(
                f"fused/{mode}/{mm} (aim100, 2000 steps)",
                lambda o=ode: init_state(fa_aim, 2048, jax.random.PRNGKey(7), o),
                fn,
                repeats,
                fields,
            )
        # the scan path's accumulators: gather sums in a fixed order;
        # segment_sum is a scatter-add, whose order a GPU may vary
        for strategy in ("gather", "segment_sum"):
            ode = ODEConfig(dv_strategy=strategy, **kwargs)
            fn = make_chunk_runner(fa_big, 0.001, ode, 500, donate=False)
            ok &= run_repeats(
                f"scan-{strategy}/{mode} (n=900, 500 steps)",
                lambda o=ode: init_state(fa_big, 512, jax.random.PRNGKey(7), o),
                lambda st, _fn=fn: _fn(st, dev_big),
                repeats,
                fields,
            )

    sfn = make_stoch_chunk_runner(fa_aim, 2000, donate=False)
    ok &= run_repeats(
        "stoch scan (aim100, 2000 steps)",
        lambda: init_stoch_state(fa_aim, 2048, jax.random.PRNGKey(7)),
        sfn,
        repeats,
        ("v", "xl", "done"),
    )

    # device-loop dispatch: the on-device multi-chunk while_loop around
    # the fused kernel — same-seed repeats must be bit-identical
    # INCLUDING the traced chunk-bound short-circuit
    ode_dl = ODEConfig(step_size=0.01, dv_strategy="fused")
    multi = make_multi_chunk_runner(fa_aim, 0.001, ode_dl, 250, 8, core_only=True)
    assert multi is not None

    def ode_device_loop(st):
        out, _ = multi(st, dev_aim)
        return out

    ok &= run_repeats(
        "device-loop ODE (aim100, 8x250 steps)",
        lambda: init_state(fa_aim, 2048, jax.random.PRNGKey(7), ode_dl),
        ode_device_loop,
        repeats,
        fields,
    )

    print("SOAK", "PASSED" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
