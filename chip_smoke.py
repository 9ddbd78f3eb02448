#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mloam_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card (label propagation:
integer-exact; k-NN: distances to 1e-5 relative, indices equal wherever
neighbouring distances are further apart than that), times them at the shapes
the main path gives them, then drives the main path — single-LiDAR odometry,
rendered sweep to refined pose, 40 sweeps at the full width of the synthetic
VLP-16 platform — and checks the trajectory against ground truth (ATE < 5 cm)
and the kernels' launch counters (every kernel launch counted where it is
made) against the expected count per sweep.

One JSON object per line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase ends the script with a non-zero exit code and no such line.
Needs one CUDA device and nvcc; no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(1)

import numpy as np  # noqa: E402

import mloam_tpu_torch  # noqa: E402
from mloam_tpu_torch.core.rangeimage import LidarModel, RangeImage  # noqa: E402
from mloam_tpu_torch.frontend import segmentation as S  # noqa: E402
from mloam_tpu_torch.models import platforms, run_synthetic  # noqa: E402
from mloam_tpu_torch.models.pipeline import OdometryPipeline  # noqa: E402
from mloam_tpu_torch.ops import _build, hopper_knn, hopper_labels  # noqa: E402
from mloam_tpu_torch.ops import knn as knn_ops  # noqa: E402

DEV = torch.device("cuda")
N_FRAMES = 40
ATE_GATE_M = 0.05
KNN_RTOL = 1e-5

# H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KNN_FLOPS_PER_PAIR = 8      # 3 sub, 3 mul, 2 add
LABEL_OPS_PER_CELL_ROUND = 6  # 3 segmented mins, a compare and a min each


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------
# env + build
# --------------------------------------------------------------------------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit({"env": {
        "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.strip().splitlines()[-2:],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }})
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    for stem in libs:
        _build.load(stem)
    emit({"build": {"seconds": round(time.perf_counter() - t0, 3),
                    "libraries": sorted(p.name for p in libs.values())}})


# --------------------------------------------------------------------------
# K1: label propagation
# --------------------------------------------------------------------------

def random_label_case(r, c, seed):
    """Random connectivity, as the JAX package's own kernel test draws it."""
    g = torch.Generator().manual_seed(seed)
    clusterable = torch.rand((r, c), generator=g) < 0.8
    conn_h = (torch.rand((r, c), generator=g) < 0.7) & clusterable
    conn_h[:, 1:] &= clusterable[:, :-1]
    conn_h[:, 0] &= clusterable[:, -1]
    conn_v = (torch.rand((r, c), generator=g) < 0.6) & clusterable
    conn_v[1:] &= clusterable[:-1]
    conn_v[0] = False
    labels = torch.arange(r * c, dtype=torch.int32).reshape(r, c)
    labels = torch.where(clusterable, labels, r * c)
    return labels.to(DEV), conn_h.to(DEV), conn_v.to(DEV)


def rendered_label_case(img, model, cfg):
    _, clusterable, conn_h, conn_v = S.connectivity(img, model, cfg.segmenter)
    r, c = clusterable.shape
    labels = torch.arange(r * c, dtype=torch.int32, device=DEV).reshape(r, c)
    return torch.where(clusterable, labels, r * c), conn_h, conn_v


def check_labels(name, case, rounds_list=(3, 8)):
    out = []
    for rounds in rounds_list:
        got = hopper_labels.propagate_labels(*case, rounds=rounds)
        torch.cuda.synchronize()
        want = hopper_labels.propagate_labels_plain(*case, rounds=rounds)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        changed = int((got != case[0]).sum())
        if err != 0:
            fail(f"labels kernel differs from its plain version on {name} "
                 f"rounds={rounds}: max abs diff {err}")
        out.append({"case": name, "shape": list(case[0].shape),
                    "rounds": rounds, "max_abs_err": err,
                    "cells_relabelled": changed})
    return out


def label_bound_ms(r, c, rounds):
    cells = r * c
    t_bytes = cells * (4 + 1 + 1 + 4) / PEAK_BYTES_S
    t_ops = cells * rounds * LABEL_OPS_PER_CELL_ROUND / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# K2: k-NN
# --------------------------------------------------------------------------

def check_knn(name, q, r, m, k):
    d, i = hopper_knn.knn(q, r, m, k)
    torch.cuda.synchronize()
    dp, ip = knn_ops.knn_plain(q, r, m, k)
    if d.shape != (q.shape[0], k) or i.shape != d.shape or i.dtype != torch.int64:
        fail(f"knn {name}: wrong output shape/dtype")
    if int(i.min()) < 0 or int(i.max()) >= r.shape[0]:
        fail(f"knn {name}: index out of [0, Nr)")
    real = dp < 1e29
    if not torch.equal(real, d < 1e29):
        fail(f"knn {name}: masked/padded slots differ from the plain version")
    if not bool((d[~real] == 1e30).all()):
        fail(f"knn {name}: empty slots must hold d2 = 1e30")
    tol = KNN_RTOL * dp.abs().clamp(min=1e-6)
    err = (d - dp).abs()
    if bool((real & (err > tol)).any()):
        fail(f"knn {name}: distances differ, max abs err "
             f"{float(err[real].max())}")
    # indices must agree wherever the neighbouring distances (in the sorted
    # list) are further apart than the tolerance: ties may order either way
    gap_prev = torch.full_like(dp, float("inf"))
    gap_next = torch.full_like(dp, float("inf"))
    if k > 1:
        gap_prev[:, 1:] = dp[:, 1:] - dp[:, :-1]
        gap_next[:, :-1] = dp[:, 1:] - dp[:, :-1]
    distinct = real & (gap_prev > 2 * tol) & (gap_next > 2 * tol)
    # the index a slot returns must be a reference at the distance it returns
    back = ((q[:, None, :] - r[i]) ** 2).sum(-1)
    if bool((real & ((back - d).abs() > tol)).any()):
        fail(f"knn {name}: returned indices do not lie at the returned distances")
    if bool((real & ~m[i]).any()):
        fail(f"knn {name}: a masked reference was returned")
    # and must be the plain version's index at distinct distances; the k-th
    # slot may also tie with the unseen (k+1)-th, so it is only counted
    mismatch = distinct & (i != ip)
    if bool(mismatch[:, :k - 1].any()):
        fail(f"knn {name}: {int(mismatch[:, :k - 1].sum())} indices differ "
             "at distinct distances")
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    return {"case": name, "nq": q.shape[0], "nr": r.shape[0], "k": k,
            "valid_refs": int(m.sum()), "max_abs_err": max_err,
            "indices_compared": int(distinct.sum()),
            "kth_slot_index_differs": int(mismatch.sum())}


def knn_bound_ms(nq, nr, n_valid, k):
    t_ops = nq * n_valid * KNN_FLOPS_PER_PAIR / PEAK_F32_FLOPS
    t_bytes = (nq * 12 + nr * 12 + nr + nq * k * 12) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_knn(q, r, m, k):
    d = torch.cdist(q, r)
    d = torch.where(m[None, :], d, float("inf"))
    return torch.topk(d, min(k, r.shape[0]), dim=1, largest=False)


def knn_edge_cases():
    g = torch.Generator().manual_seed(7)
    def pts(n, scale=20.0):
        return ((torch.rand((n, 3), generator=g) - 0.5) * scale).to(DEV)
    cases = []
    q, r = pts(300), pts(1500)
    m = torch.ones(1500, dtype=torch.bool, device=DEV)
    for k in (1, 5, 8):
        cases.append((f"dense_k{k}", q, r, m, k))
    m2 = (torch.rand(1500, generator=g) < 0.02).to(DEV)
    cases.append(("almost_all_masked_k5", q, r, m2, 5))
    cases.append(("all_masked_k3", q, r, torch.zeros_like(m), 3))
    r3 = pts(1031)   # not a multiple of the 1024-point tile
    cases.append(("ragged_tile_k8", q, r3, torch.ones(1031, dtype=torch.bool, device=DEV), 8))
    r4 = pts(3)
    cases.append(("nr_lt_k", pts(70), r4, torch.ones(3, dtype=torch.bool, device=DEV), 5))
    far = pts(2000, 0.5) + torch.tensor([80.0, -60.0, 2.0], device=DEV)
    cases.append(("lidar_range_offsets_k5", far[:500], far, torch.ones(2000, dtype=torch.bool, device=DEV), 5))
    return cases


# --------------------------------------------------------------------------
# capture the main path's kernel inputs
# --------------------------------------------------------------------------

def capture_main_path_inputs(cfg):
    """Run the pipeline until the window is warm and record, on the first
    steady sweep, the tensors the main path hands to each kernel."""
    n = cfg.odometry.window_size + 2
    imgs, _ = run_synthetic.render(cfg, n, seed=1, device=DEV)
    pipe = OdometryPipeline(cfg, device=DEV)
    knn_calls, label_calls = [], []
    real_knn, real_labels = hopper_knn.knn, hopper_labels.propagate_labels

    def rec_knn(q, r, m, k):
        knn_calls.append((q.clone(), r.clone(), m.clone(), k))
        return real_knn(q, r, m, k)

    def rec_labels(labels, ch, cv, rounds=3):
        label_calls.append((labels.clone(), ch.clone(), cv.clone(), rounds))
        return real_labels(labels, ch, cv, rounds)

    for i in range(n):
        img = RangeImage(*(f[i] for f in imgs))
        if i == n - 1:
            hopper_knn.knn, hopper_labels.propagate_labels = rec_knn, rec_labels
        try:
            pipe.process([img])
        finally:
            hopper_knn.knn, hopper_labels.propagate_labels = real_knn, real_labels
    torch.cuda.synchronize()
    if len(knn_calls) != 4 or len(label_calls) != 1:
        fail(f"steady sweep made {len(knn_calls)} k-NN and {len(label_calls)} "
             "label calls; expected 4 and 1")
    last_img = RangeImage(*(f[n - 1] for f in imgs))
    return knn_calls, label_calls[0], last_img


def phase_kernels(cfg):
    model = cfg.rig.models[0]
    knn_calls, label_call, img = capture_main_path_inputs(cfg)

    # ---- K1 correctness
    label_checks = []
    for (r, c) in ((16, 1800), (32, 2160), (64, 1800), (5, 37)):
        label_checks += check_labels(f"random_{r}x{c}", random_label_case(r, c, r + c))
    label_checks += check_labels("rendered_frame", rendered_label_case(img, model, cfg))
    label_checks += check_labels("main_path", label_call[:3], (label_call[3],))
    # ---- K1 timing at the main-path shape
    lab, ch, cv, rounds = label_call
    n0 = hopper_labels.launches
    hopper_labels.propagate_labels(lab, ch, cv, rounds)
    k1_launches_per_call = hopper_labels.launches - n0   # counted by the C entry
    if k1_launches_per_call != 2 * rounds:
        fail(f"labels: one call of {rounds} rounds made {k1_launches_per_call} "
             f"kernel launches; the design is two per round")
    k1_ms = time_ms(lambda: hopper_labels.propagate_labels(lab, ch, cv, rounds))
    k1_plain = time_ms(lambda: hopper_labels.propagate_labels_plain(lab, ch, cv, rounds), reps=5)
    k1_bound, k1_by = label_bound_ms(lab.shape[0], lab.shape[1], rounds)

    # ---- K2 correctness
    knn_checks = [check_knn(*c) for c in knn_edge_cases()]
    names = ("tracker_edge", "tracker_plane", "window_edge", "window_plane")
    shapes = []
    for name, (q, r, m, k) in zip(names, knn_calls):
        chk = check_knn(f"main_path_{name}", q, r, m, k)
        knn_checks.append(chk)
        ms = time_ms(lambda: hopper_knn.knn(q, r, m, k))
        plain = time_ms(lambda: knn_ops.knn_plain(q, r, m, k), reps=5)
        lib = time_ms(lambda: library_knn(q, r, m, k), reps=5)
        bound, by = knn_bound_ms(q.shape[0], r.shape[0], chk["valid_refs"], k)
        shapes.append({"name": name, "nq": q.shape[0], "nr": r.shape[0], "k": k,
                       "valid_refs": chk["valid_refs"],
                       "max_abs_err": chk["max_abs_err"], "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bound, "bound_by": by})
    emit({"kernel_checks": {"labels": label_checks, "knn": knn_checks}})

    big = max(shapes, key=lambda s: s["nq"] * s["nr"])
    return [
        {"name": "propagate_labels", "route": "cuda",
         "source": "mloam_tpu_torch/csrc/labels.cu",
         "replaces": "mloam_tpu/ops/pallas_labels.py:58",
         "shape": list(lab.shape), "rounds": rounds,
         "kernel_launches_per_call": k1_launches_per_call,
         "max_abs_err": max(c["max_abs_err"] for c in label_checks),
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "knn", "route": "cuda",
         "source": "mloam_tpu_torch/csrc/knn.cu",
         "replaces": "mloam_tpu/ops/pallas_knn.py:55",
         "shape": {k: big[k] for k in ("name", "nq", "nr", "k", "valid_refs")},
         "max_abs_err": max(s["max_abs_err"] for s in shapes),
         "ms": big["ms"], "plain_ms": big["plain_ms"],
         "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
         "library_ms": big["library_ms"],
         "per_sweep_ms": sum(s["ms"] for s in shapes),
         "main_path_shapes": shapes},
    ]


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------

def phase_main_path(cfg, kernels):
    hopper_labels.launches = 0
    hopper_knn.launches = 0
    res = run_synthetic.run(n_frames=N_FRAMES, seed=0, verbose=False,
                            device=DEV, cfg=cfg)
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches

    ws = cfg.odometry.window_size
    # one call per sweep, each of as many kernel launches as one call was
    # counted to make on the main path's input
    want_labels = N_FRAMES * kernels[0]["kernel_launches_per_call"]
    # sweep 0 matches nothing; warm-up sweeps run the tracker's two matchers;
    # from the warm window on, the two map matchers as well
    want_knn = 2 * (ws - 1) + 4 * (N_FRAMES - ws)
    if n_labels != want_labels or n_knn != want_knn:
        fail(f"launch counters: labels {n_labels} (expected {want_labels}), "
             f"knn {n_knn} (expected {want_knn}) — the run did not go "
             "through the kernels as expected")
    est_t, est_q = res["est_t"], res["est_q"]
    if est_t.shape != (N_FRAMES, 3) or est_q.shape != (N_FRAMES, 4):
        fail("trajectory has the wrong shape")
    if not (np.isfinite(est_t).all() and np.isfinite(est_q).all()):
        fail("trajectory holds non-finite poses")
    if not res["ate_m"] < ATE_GATE_M:
        fail(f"ATE {res['ate_m']:.4f} m is not under the {ATE_GATE_M} m gate")
    path_m = float(np.linalg.norm(np.diff(res["gt_t"], axis=0), axis=1).sum())
    emit({"main_path": {
        "frames": N_FRAMES, "ate_m": res["ate_m"], "path_m": path_m,
        "steady_ms_median": res["steady_ms_median"],
        "steady_fps": res["fps"],
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "width": {"range_image": [cfg.rig.models[0].n_rings, cfg.rig.models[0].n_cols],
                  "cap_frame_corner": cfg.odometry.cap_frame_corner,
                  "cap_frame_surf": cfg.odometry.cap_frame_surf,
                  "cap_less_flat": cfg.features.cap_less_flat,
                  "window_size": ws,
                  "opt_window_size": cfg.odometry.opt_window_size},
    }})
    kernels[0]["launches"] = n_labels
    kernels[1]["launches"] = n_knn


def main():
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    cfg = platforms.synthetic(n_lidars=1)
    assert cfg.rig.models[0] == LidarModel(n_rings=16, n_cols=1800)
    kernels = phase_kernels(cfg)
    phase_main_path(cfg, kernels)
    emit({"kernels": kernels})
    emit({"seconds": round(time.perf_counter() - t0, 1),
          "package": mloam_tpu_torch.__version__})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
