"""Time one hand-written kernel against other builds of it on one GPU, in
turns.

Builds the package's source of kernel 1, 2, 3 or 4 and any number of variants
(another source with the same C entry point, for example the file of an
earlier commit), runs each on the step-0 QPs of the headline states, and
prints one JSON line per variant:

* kernel 1 (``csrc/constraints.cu``): its time with the Jacobian on the
  step-0 iterates (F = 19 B evaluations) and values only on ten copies of
  them (the line search's launch), through the wrapper on an idle card
  (host time included) and for the launch alone on the device's clock
  (queued behind a long product); whether its outputs are bitwise the
  package build's; the largest difference of g and J from the plain
  path's.
* kernel 2 (``csrc/banded_factor.cu``): its time; whether its outputs are
  bitwise the package build's; whether its ``ok`` flags are those of the
  plain ``factor_banded``; the max-norm relative error of ``Ldi``, ``Lsub``,
  ``u``, ``s`` against it.
* kernel 3 (``csrc/structured_admm.cu``) and kernel 4
  (``csrc/admm_dense.cu``): its time at the full iteration budget and at
  exactly one check window; the drift of one check window from a float64
  run of the plain loop next to the plain float32 loop's (the bar of
  ``chip_smoke.py`` phases 4 and 7); the largest difference of its iterates
  from the package kernel's after one window, how many iteration counts
  at the full budget differ from the package kernel's, and whether each
  launch's outputs are bitwise the package kernel's.

Times are CUDA events around ``--reps`` calls, the variants in turns (first
to last, then last to first). ``--segments`` and ``--order`` set the
transcription (spline segments of an order, 6 of order 3 by default: 19
nodes; 8 segments give 25 nodes, 4 of order 4 give 17), as a user sets it:
``planner.ocp = make_ocp(model, tool_frame, order=4, num_segments=4)``,
with the shipping QP settings of its node count
(``config.shipping_qp_settings``: one KKT refinement step from 43 nodes);
kernels 2 and 3 and their variants are built for it (a variant from before
the kernels took other band widths builds for order 3 only). ``--urdf`` takes
another robot, a Panda with its last joints locked (for example
``tests/fixtures/panda_joint7_fixed.urdf``, 6 joints; the headline states'
entries of its joints and the Panda's limits of them, as
``profile_solve.py`` takes it), and kernels 1-3 are built for its joint
count. ``--layout`` (kernel 3) adds the package's source built in that
shared-memory layout (``full``, ``compact``, ``split``, ``stream``, ``lean``, ``far``,
``deep`` or ``pair``) as the
variant ``layout_<name>``, beside the package build in the layout its
geometry takes: ``--segments 8 --layout split`` (or ``stream``) holds the
split (or stream) layout against the compact one where both fit (their
outputs must be bitwise equal) and times what it costs; ``--order 4
--segments 6`` is a geometry that takes the split layout (``--layout
stream`` there holds the stream against the split), ``--segments 12`` one
that takes the stream layout (37 nodes, 992 threads; ``--layout lean`` there
holds the lean layout against it), ``--segments 20`` one that takes the lean
layout (61 nodes, 832 threads; ``--layout far`` there holds the far layout
against it), ``--segments 25`` one that takes the far layout (76 nodes, 1024
threads; ``--layout deep`` there holds the deep layout against it), ``--segments
32`` one that takes the deep layout (97 nodes, 864 threads; ``--layout pair``
there holds the pair layout, a cluster of two blocks a problem, against it),
``--segments 52`` one that takes the pair layout (157 nodes). Kernel 3's
lines carry a window's µs per iteration per block, or per cluster of two
blocks in the pair layout, over the waves of problems the card runs at a
time (``problems_at_once``). ``--ept`` (kernel 3)
adds the package's source built with that many z elements and rows per
thread as the variant ``ept_<n>``: ``--segments 12 --ept 2`` holds two
elements a thread (512 threads) against one (992) where both fit; at
``--segments 15`` (46 nodes, 608 threads) the geometry's own count is 2.
``--chain NQ`` plans the seeded serial chain of NQ joints and its states
(``bench/convergence.py`` ``chain``, as ``chip_smoke.py`` plans it, no floor
for its tool) in place of the Panda: ``--chain 12`` times kernels 1-3 with
blocks of 36 x 36, two rows a lane.

    python -m mpc_motion_planner_tpu_torch.bench.kernel_ab --kernel 4 \\
        [--batch 2048] [--reps 3] [--segments 6] [--order 3] [--urdf path.urdf] \\
        [--layout lean] [--ept 2] [--chain 12] [name=path.cu ...]

A variant's headers are looked up beside its source. To compare with an
earlier commit:

    git show <commit>:mpc_motion_planner_tpu_torch/csrc/admm_dense.cu > build/variants/old.cu
    git show <commit>:mpc_motion_planner_tpu_torch/csrc/common.cuh > build/variants/common.cuh

Three C interfaces have changed since the kernels were first written, and a
variant that still has the earlier one is recognised by its source and
called through it: kernel 1 before it read its inputs in place (one
concatenated ``xu`` array; the earlier wrapper's ``torch.cat`` copy is then
part of the wrapper's time), kernel 1 before it read the robot from device
memory (the robot's host constants, which the launch copies into its
parameters), and kernel 3 before it took the ADMM state and ``kkt_refine``
(it starts from the initial state, as every call here does).

Needs one CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import config
from ..kernels import admm_dense as k4
from ..kernels import banded_factor as k2
from ..kernels import build
from ..kernels import constraints as k1
from ..kernels import structured_admm as k3
from ..ocp import make_ocp
from ..ops import qp as dense_qp
from ..ops import qp_structured
from ..ops.sqp import SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights
from ..planner import Margins, MotionPlanner
from .convergence import chain
from .profile_solve import locked_panda

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
MODULES = {1: k1, 2: k2, 3: k3, 4: k4}
# the dense path's configuration on the headline (chip_smoke.py phase 7)
DENSE = dense_qp.QPSettings(
    backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu", ruiz_iters=2,
    rho=0.1, alpha=1.6, max_iter=700, check_every=25,
)

CHECK_BATCH = 64  # problems of the one-window comparison with float64


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def step0(planner, cur, tgt, dense):
    """The first SQP step's QP data: (P, q, constraint matrix, lc, uc, lx,
    ux) and the soft weights."""
    ocp, B, dev = planner.ocp, cur.shape[0], cur.device
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, lin, (h, lc, uc, lx, ux) = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0, dense)
    P = hessian_regularization_diag(ocp, B, torch.float32, dev, planner.sqp_settings.reg_eps)
    soft_c, soft_x = soft_weights(ocp, planner.sqp_settings, B, torch.float32, dev)
    return (P, h, lin, lc, uc, lx, ux), dict(soft_c=soft_c, soft_x=soft_x)


def structured_qp(planner, cur, tgt, settings):
    """The scaled structured QP of step 0 and its factors."""
    (P, h, sa, lc, uc, lx, ux), soft = step0(planner, cur, tgt, False)
    qp = qp_structured.scale_qp(planner.ocp, sa, P, h, lc, uc, lx, ux, settings, **soft)
    return sa, qp, k2.factor(qp.Mband, qp.p_col, qp.m_pp, planner.ocp.coll.order)


def dense_chunk_inputs(planner, cur, tgt):
    """Kernel 4's operands and initial state for the dense QP of step 0."""
    args, soft = step0(planner, cur, tgt, True)
    dq = dense_qp.scale_dense_qp(*args, DENSE, **soft)
    rho = torch.full((cur.shape[0],), DENSE.rho, dtype=torch.float32, device=cur.device)
    return dense_qp.pallas_operands(dq, rho, dq.factor(rho, DENSE)), dense_qp.pallas_state(dq)


def run_with(module, kernel, fn, *args, **kw):
    """Call a wrapper of ``module`` through another build of its kernel."""
    saved = module.KERNEL
    module.KERNEL = kernel
    try:
        return fn(*args, **kw)
    finally:
        module.KERNEL = saved


class EarlierAdmmKernel(build.CudaKernel):
    """A build of kernel 3 with the interface it had before it took the ADMM
    state and ``kkt_refine``: 33 pointers, no refinement argument."""

    STATE_IN = slice(24, 28)  # rp0, rd0, done0, iters0 in struct Ptrs

    def __init__(self, name, source):
        super().__init__(name, source, k3.KERNEL.entry,
                         [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 4
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p], per_geometry="transcription")

    def launch(self, ptrs, Dm, sigma, alpha, eps_abs, eps_rel, cap, check_every, kkt_refine, B,
               geometry=None):
        if kkt_refine:
            raise ValueError("this build of kernel 3 has no KKT refinement")
        keep = list(ptrs)
        del keep[self.STATE_IN]
        super().launch((ctypes.c_void_p * len(keep))(*keep), Dm, sigma, alpha, eps_abs,
                       eps_rel, cap, check_every, B, geometry=geometry)


class EarlierConstraintsKernel(build.CudaKernel):
    """A build of kernel 1 with the interface it had before it read its
    inputs in place: one contiguous (F, 21) array of [q, qdot, u]."""

    def __init__(self, name, source):
        super().__init__(name, source, k1.KERNEL.entry,
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


class ByValueConstraintsKernel(build.CudaKernel):
    """A build of kernel 1 with the interface it had while the robot
    travelled by value: the package's arguments, but the robot's host
    constants where the package passes its device pointer (``consts``, set
    per model by :func:`ab_constraints`)."""

    consts = None

    def __init__(self, name, source, init):
        k = k1.KERNEL
        super().__init__(name, source, k.entry, k.argtypes, init=init,
                         per_geometry=k.per_geometry)

    def launch(self, robot, *args, geometry=None):
        super().launch(self.consts.ctypes.data_as(ctypes.c_void_p), *args, geometry=geometry)


def earlier_constraints(kernel, ocp, X, U, with_jac, xu=None):
    """Kernel 1's wrapper as it was with that interface: ``torch.cat`` of X
    and U into ``xu`` (skipped if ``xu`` is given: the launch alone)."""
    B, nodes = X.shape[0], X.shape[1]
    consts, tool_parent = k1.bake_model(ocp.model, ocp.tool_frame)
    if xu is None:
        xu = torch.cat([X, U], dim=-1).reshape(B * nodes, 21).to(torch.float32).contiguous()
    F = xu.shape[0]
    g = torch.empty(F, 8, dtype=torch.float32, device=xu.device)
    J = torch.empty(F, 8, 21, dtype=torch.float32, device=xu.device) if with_jac else None
    kernel.launch(consts.ctypes.data_as(ctypes.c_void_p), tool_parent, build.ptr(xu), build.ptr(g),
                  build.ptr(J) if with_jac else None, F, int(with_jac))
    g = g.reshape(B, nodes, 8)
    return (g, J.reshape(B, nodes, 8, 21)) if with_jac else g


def variant_kernel(number, name, path):
    """The build of a variant source, through the interface its source has."""
    text = open(path).read()
    label = f"{MODULES[number].KERNEL.name}_{name}"
    k = MODULES[number].KERNEL
    # sources from before the init entry point set the attributes in every launch
    init = k.init if k.init is not None and k.init in text else None
    if number == 1 and "x_stride" not in text:
        return EarlierConstraintsKernel(label, path)
    if number == 1 and "robot_bytes" not in text:
        return ByValueConstraintsKernel(label, path, init)
    if number == 3 and "kkt_refine" not in text:
        return EarlierAdmmKernel(label, path)
    return build.CudaKernel(label, path, k.entry, k.argtypes, init=init,
                            per_geometry=k.per_geometry, resolve=k.resolve)


def time_in_turns(kernels, call, reps, behind=None):
    """ms per call of ``call(kernel)`` for each build, first to last and
    last to first, after one warm-up call each. Returns (times, the warm-up
    calls' outputs). ``behind``: a function that keeps the card busy for
    longer than the host needs to enqueue ``reps`` calls; the calls then
    queue up behind it and the events time the device alone, which matters
    for a kernel shorter than its wrapper's host time."""
    out = {name: call(k) for name, k in kernels.items()}
    torch.cuda.synchronize()
    times = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if behind is not None:
            behind()
        start.record()
        for _ in range(reps):
            call(kernels[name])
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
    return times, out


def ab_constraints(kernels, planner, cur, tgt, reps):
    """Kernel 1 on the step-0 iterates: with the Jacobian (the linearization's
    launch) and values only on ten copies (the line search's launch)."""
    ocp = planner.ocp
    for k in kernels.values():
        if isinstance(k, ByValueConstraintsKernel):
            k.consts = k1.bake_model(ocp.model, ocp.tool_frame)[0]
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    zl = z0.repeat(10, 1)
    results = {name: {} for name in kernels}
    big = torch.ones(8192, 8192, device=z0.device)
    busy = lambda: big @ big  # tens of ms of float32 product
    for label, z, with_jac in (("jacobian", z0, True), ("values", zl, False)):
        X, U, _ = ocp.unpack(z)
        xu = torch.cat([X, U], dim=-1).reshape(-1, 3 * ocp.nq).contiguous()
        plain = k1.node_constraints_plain(ocp, X, U, with_jac)

        def wrapper(k):
            if isinstance(k, EarlierConstraintsKernel):
                return earlier_constraints(k, ocp, X, U, with_jac)
            return run_with(k1, k, k1.node_constraints_kernel, ocp, X, U, with_jac)

        def launch(k):
            if isinstance(k, EarlierConstraintsKernel):
                return earlier_constraints(k, ocp, X, U, with_jac, xu=xu)
            return wrapper(k)  # reads X and U in place: nothing but the launch

        # wrapper: on an idle card, the host's time included; device: the
        # launch alone, queued behind a long product
        for what, call, behind in (("wrapper", wrapper, None), ("device", launch, busy)):
            times, out = time_in_turns(kernels, call, reps, behind)
            for name in kernels:
                r = results[name]
                r[f"{label}_{what}_ms"] = float(np.mean(times[name]))
                r[f"{label}_{what}_ms_runs"] = times[name]
                got = out[name] if with_jac else (out[name],)
                ref = plain if with_jac else (plain,)
                pkg = out["package"] if with_jac else (out["package"],)
                r[f"{label}_evaluations"] = X.shape[0] * X.shape[1]
                r[f"{label}_{what}_bitwise_package"] = all(
                    torch.equal(a, b) for a, b in zip(got, pkg))
                r[f"{label}_max_abs_err_g"] = max_abs(got[0], ref[0])
                if with_jac:
                    r["jacobian_max_abs_err_J"] = max_abs(got[1], ref[1])
    return results


def ab_factor(kernels, planner, cur, tgt, reps):
    """Kernel 2 on the step-0 KKT matrices."""
    (P, h, sa, lc, uc, lx, ux), soft = step0(planner, cur, tgt, False)
    qp = qp_structured.scale_qp(planner.ocp, sa, P, h, lc, uc, lx, ux,
                                planner.qp_settings, **soft)
    data = (qp.Mband, qp.p_col, qp.m_pp)
    plain = qp_structured.factor_banded(*data, planner.ocp.coll.order)
    times, out = time_in_turns(
        kernels, lambda k: run_with(k2, k, k2.factor_banded_kernel, *data), reps)
    results = {}
    for name, fac in out.items():
        results[name] = {
            "ms": float(np.mean(times[name])), "ms_runs": times[name],
            "bitwise_package": all(torch.equal(fac[k], out["package"][k]) for k in fac),
            "ok_flags_equal_plain": bool(torch.equal(fac["ok"], plain["ok"])),
            "ok_count": int(fac["ok"].sum()),
            **{f"rel_err_{key}": max_abs(fac[key], plain[key])
               / max(float(plain[key].abs().max()), 1e-30) for key in ("Ldi", "Lsub", "u", "s")},
        }
    return results


def ab_loop(kernels, run, run_plain, run_float64, inputs, budget, window, reps, batch):
    """Kernel 3 or 4: ``run(kernel, inputs, max_iter)`` returns (x, done,
    iterations) of one launch."""
    results = {name: {} for name in kernels}
    small = inputs(min(CHECK_BATCH, batch))
    x64 = run_float64(small, window)
    e_plain = max_abs(run_plain(small, window)[0], x64)
    for name, k in kernels.items():
        x = run(k, small, window)[0]
        torch.cuda.synchronize()
        results[name].update(window_drift_from_float64=max_abs(x, x64),
                             plain_float32_drift=e_plain)
    full = inputs(batch)
    for label, iters in (("budget", budget), ("window", window)):
        times, out = time_in_turns(kernels, lambda k: run(k, full, iters), reps)
        ref = out["package"]
        for name in kernels:
            r = results[name]
            r[f"{label}_ms"] = float(np.mean(times[name]))
            r[f"{label}_ms_runs"] = times[name]
            r[f"{label}_bitwise_package"] = all(torch.equal(a, b) for a, b in zip(out[name], ref))
            if label == "window":
                r["window_max_abs_diff_from_package"] = max_abs(out[name][0], ref[0])
            else:
                r["budget_iters_sum"] = int(out[name][2].sum())
                r["budget_converged"] = int((out[name][1] == 1).sum())
                r["budget_iters_differ_from_package"] = int((out[name][2] != ref[2]).sum())
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, choices=sorted(MODULES), required=True)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--segments", type=int, default=6,
                    help="spline segments (6 of order 3: 19 nodes; 8: 25 nodes)")
    ap.add_argument("--order", type=int, default=3,
                    help="spline order, the band width of kernels 2 and 3 (4 x 4 segments: "
                         "17 nodes)")
    ap.add_argument("--urdf", help="a Panda with its last joints locked (default: the Panda)")
    ap.add_argument("--chain", type=int, help="plan the seeded serial chain of this many joints")
    ap.add_argument("--layout", choices=build.LAYOUTS,
                    help="kernel 3: add the package's source built in this shared-memory layout")
    ap.add_argument("--ept", type=int,
                    help="kernel 3: add the package's source built with this many z elements "
                         "and rows per thread")
    ap.add_argument("variants", nargs="*", help="name=path.cu")
    a = ap.parse_args(argv)
    if (a.layout or a.ept) and a.kernel != 3:
        ap.error("--layout and --ept are kernel 3's")
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config.full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    module = MODULES[a.kernel]
    kernels = {"package": module.KERNEL}
    for spec in a.variants:
        name, _, path = spec.partition("=")
        kernels[name] = variant_kernel(a.kernel, name, os.path.abspath(path))
    # the package's kernel 3, built in that layout or at that ept at every geometry
    for label, named in ((f"layout_{a.layout}", {"layout": a.layout}),
                         (f"ept_{a.ept}", {"ept": a.ept})):
        if not all(named.values()):
            continue
        k = k3.KERNEL
        kernels[label] = build.CudaKernel(
            k.name, k.source, k.entry, k.argtypes, init=k.init, per_geometry=k.per_geometry,
            resolve=lambda g, named=named: k3.built_geometry(dataclasses.replace(g, **named)))
    model, limits, cols = (locked_panda(a.urdf, torch.float32, dev) if a.urdf
                           else (None, None, list(range(14))))
    tool, states = "panda_tool", np.load(STATES)
    if a.chain:
        model, limits, tool, cur, tgt = chain(a.chain, a.batch, torch.float32, dev)
        cols = list(range(2 * a.chain))
        states = {"current": cur.cpu().numpy(), "target": tgt.cpu().numpy()}
    geometry = build.Geometry(segments=a.segments, order=a.order, nq=len(cols) // 2)
    for name, k in kernels.items():
        k.function(geometry)
        built = k.geometry(geometry)
        info = [ln.strip() for ln in k.build_log.get(built, "").splitlines()
                if "registers" in ln or "spill" in ln]
        layout = (f" ({built.layout} layout, {built.ept} per thread)"
                  if built is not None and built.layout else "")
        print(f"built {name}{layout}: " + " | ".join(info), flush=True)

    shipping = config.SHIPPING_QP_SETTINGS
    planner = MotionPlanner(
        model=model, limits=limits, tool_frame=tool, margins=Margins(*MARGINS),
        dtype=torch.float32, device=dev, qp_settings=shipping,
        sqp_settings=SQPSettings(qp_step_schedules=config.shipping_sqp_schedules(shipping.backend)),
    )
    if a.chain:
        planner.set_min_height(-10.0)  # a random chain: no floor for its tool
    if (a.segments, a.order) != (6, 3):
        planner.ocp = make_ocp(planner.model, planner.tool_frame, order=a.order,
                               num_segments=a.segments)
        shipping = planner.qp_settings = config.shipping_qp_settings(planner.ocp.num_nodes)
    ocp = planner.ocp
    cur = torch.as_tensor(states["current"][: a.batch][:, cols], device=dev)
    tgt = torch.as_tensor(states["target"][: a.batch][:, cols], device=dev)
    to64 = lambda d: {k: (v.double() if v.is_floating_point() else v) for k, v in d.items()}

    if a.kernel == 1:
        results = ab_constraints(kernels, planner, cur, tgt, a.reps)
        shape = {}
    elif a.kernel == 2:
        results = ab_factor(kernels, planner, cur, tgt, a.reps)
        shape = {}
    elif a.kernel == 3:
        # the budget with the rescue iterations of the shipping settings, a
        # window without them
        at = lambda n: dataclasses.replace(
            shipping, max_iter=n,
            rescue_iters=shipping.rescue_iters if n == shipping.max_iter else 0)
        pick = lambda out: (out[0], out[5], out[6])
        ocp64 = make_ocp(planner.model.to(dtype=torch.float64), planner.tool_frame,
                         order=a.order, num_segments=a.segments)

        def float64(data, n):
            sa, qp, fac = data
            qp64 = qp_structured.ScaledQP(
                *(getattr(qp, f.name).double() for f in dataclasses.fields(qp)))
            fac64 = {k: v.double() for k, v in fac.items() if k != "ok"}
            return qp_structured.admm_plain(ocp64, sa.to(dtype=torch.float64), qp64, fac64,
                                            at(n))[0]

        results = ab_loop(
            kernels,
            run=lambda k, data, n: pick(run_with(k3, k, k3.admm_kernel, ocp, *data, at(n))),
            run_plain=lambda data, n: pick(qp_structured.admm_plain(ocp, *data, at(n))),
            run_float64=float64,
            inputs=lambda nb: structured_qp(planner, cur[:nb], tgt[:nb], shipping),
            budget=shipping.max_iter, window=shipping.check_every, reps=a.reps, batch=a.batch)
        shape = {"budget": shipping.max_iter, "window": shipping.check_every}
    else:
        ckw = dict(check_every=DENSE.check_every, eps_abs=DENSE.eps_abs, eps_rel=DENSE.eps_rel,
                   sigma=DENSE.sigma, alpha=DENSE.alpha, kkt_refine=DENSE.kkt_refine)

        def pick(out):
            state, used = out
            return state["x"], state["done"], used

        results = ab_loop(
            kernels,
            run=lambda k, data, n: pick(run_with(k4, k, k4.admm_dense_kernel, *data,
                                                 chunk_iters=n, **ckw)),
            run_plain=lambda data, n: pick(k4.admm_dense_plain(*data, chunk_iters=n, **ckw)),
            run_float64=lambda data, n: k4.admm_dense_plain(
                to64(data[0]), to64(data[1]), chunk_iters=n, **ckw)[0]["x"],
            inputs=lambda nb: dense_chunk_inputs(planner, cur[:nb], tgt[:nb]),
            budget=DENSE.max_iter, window=DENSE.check_every, reps=a.reps, batch=a.batch)
        shape = {"budget": DENSE.max_iter, "window": DENSE.check_every}

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, r in results.items():
        built = kernels[name].geometry(geometry)
        layout = {"layout": built.layout, "ept": built.ept} if a.kernel == 3 else {}
        if a.kernel == 3:
            # a window's µs per iteration per block, or per cluster of two
            # blocks (the pair layout), over the waves of problems the card runs
            at_once = run_with(k3, kernels[name], k3.problems_at_once, built, sms)
            unit = "cluster" if built.layout in k3.PAIRED else "block"
            layout.update({"problems_at_once": at_once, f"window_us_per_iteration_per_{unit}":
                           1e3 * r["window_ms"] / shipping.check_every / -(-a.batch // at_once)})
        print(json.dumps({"kernel": a.kernel, "variant": name, "batch": a.batch,
                          "nodes": ocp.num_nodes, "order": ocp.coll.order, "joints": ocp.nq,
                          **layout, **shape, **r}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
