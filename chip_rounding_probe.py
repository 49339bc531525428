#!/usr/bin/env python3
"""How PyTorch's CUDA ops round the float32 arithmetic that the splat
kernel K8 (csrc/splat.cu), the fuse kernels K6 / K7 (csrc/fuse.cu), the
sphere tracer K11 (csrc/raycast.cu) and the dense fusion K20
(csrc/dense.cu) repeat, bit for bit, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_rounding_probe.py [--rows 2048]

For each op the plain splat runs (``ops/splat.py``: ``voxel2world``, the
(N, 3) @ (3, 3) product and its bias, ``se3.inverse``'s einsum (and
the torch ops it may lower to), the
projection ``x / z * fx + cx``, and the smoothing's quotient) and each op
of compaction and integration (``fuse_ops``: the block centre, the product
at the table's and the visible rows' sizes, the frustum margin ``radius *
fx / zm`` (a Python double over a tensor), comparisons with Python doubles,
the truncation band, ``sample_weight`` and the running-average update and
its inverse) and of the candidate keys of allocation (``alloc_ops``: the
ray's norm on a strided frame, its reciprocal, ``torch.linspace``, the
band sample, ``se3.apply``'s product at the candidate counts of the
configs, ``world2voxel``) and of the sphere tracer (``march_ops``:
``rays_cam @ R.T`` with its transposed right operand on the whole image
and on a row slice, ``1.0 / _norm(dirs)`` and ``torch.reciprocal``,
``n_world @ R``, each also on axis-aligned rows and rotations whose
exact zeros show the sign a zero sum takes) and of the dense fusion
(``dense_ops``: the voxel centres ``origin + grid * voxel_size`` with a
0-d voxel size, ``se3.inverse``'s einsum, ``se3.apply``'s product on the
4-D (X, Y, Z, 3) grid of chip_smoke.py's ``dense`` phase and of a 512^3
volume, the projection, the truncation band, ``sample_weight``'s chain
and the running average, on the phase's orbit poses) it prints
the share of outputs that each candidate order of float32 operations
reproduces bit for bit, over ``rows`` x 512 voxels (2^20 at the default).
A candidate is evaluated in float64 on the card and rounded to float32
after every operation, so an FMA is one rounding of the exact a * b + c
(a product of two floats is exact in float64; a sum then rounds twice,
which differs from one rounding about once in 2^29).  The last line is a
JSON object: {op: {candidate: share}}.
"""

import argparse
import itertools
import json
import os
import sys

import numpy as np


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the script, no finding")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_rounding_probe.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops.hash_ops import _local_offsets

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    print(torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
          torch.__version__, torch.version.cuda, flush=True)

    def f32(x):
        return x.to(torch.float32)

    def mul(a, b):
        return f32(a.double() * b.double())

    def add(a, b):
        return f32(a.double() + b.double())

    def fma(a, b, c):
        return f32(a.double() * b.double() + c.double())

    def dvd(a, b):
        return f32(a.double() / b.double())

    def dots(a, b):
        """{name: a[0] b[0] + a[1] b[1] + a[2] b[2]} in every order and
        grouping of float32 operations: "plain_ijk" (m_i + m_j) + m_k of
        the rounded products m; "fma_ijk" fma(k, fma(j, m_i)); "fmaadd_ijk"
        fma(j, m_i) + m_k; "addfma_ijk" fma(k, m_i + m_j)."""
        m = [mul(a[k], b[k]) for k in range(3)]
        out = {}
        for p in itertools.permutations(range(3)):
            i, j, k = p
            name = "".join(map(str, p))
            if i < j:
                out[f"plain_{name}"] = add(add(m[i], m[j]), m[k])
                out[f"addfma_{name}"] = fma(a[k], b[k], add(m[i], m[j]))
            out[f"fma_{name}"] = fma(a[k], b[k], fma(a[j], b[j], m[i]))
            out[f"fmaadd_{name}"] = add(fma(a[j], b[j], m[i]), m[k])
        return out

    def share(got, want) -> float:
        return float((got.view(torch.int32) == want.view(torch.int32))
                     .float().mean())

    result = {}
    voxel_size = 0.02
    A = args.rows
    blocks = torch.as_tensor(rng.integers(-120, 120, (A, 3)),
                             dtype=torch.int32, device=dev)
    vox = blocks[:, None, :] * 8 + _local_offsets(8, device=dev)
    world = vox.to(torch.float32) * voxel_size
    result["voxel2world"] = {"mul": share(
        world, mul(vox.double(), torch.tensor(np.float32(voxel_size),
                                              device=dev)))}

    poses = []
    for k in range(8):
        xi = rng.normal(size=6) * np.array([1.5, 1.5, 1.5, 0.8, 0.8, 0.8])
        poses.append(se3.exp(torch.as_tensor(xi, dtype=torch.float32,
                                             device=dev)))
    # the product and its bias, as _splat_rows_into writes them: every
    # pose on all rows, and on 930, 100 and 1 rows (the library may pick
    # its kernel by size)
    prod_share, full_share, bias_share = {}, {}, {}
    for k, T_wc in enumerate(poses):
        rows = world[:(A, 930, 100, 1)[k % 4]]
        T_cw = se3.inverse(T_wc)
        prod = rows @ T_cw[:3, :3].T
        pc = rows @ T_cw[:3, :3].T + T_cw[:3, 3]
        M = T_cw[:3, :3].T
        for j in range(3):
            cands = dots([rows[..., i] for i in range(3)],
                         [M[i, j] for i in range(3)])
            for name, c in cands.items():
                prod_share.setdefault(name, []).append(share(prod[..., j], c))
                full_share.setdefault(name, []).append(
                    share(pc[..., j], add(c, T_cw[j, 3])))
    result["matmul"] = {n: float(np.mean(v)) for n, v in prod_share.items()}
    result["matmul_plus_bias"] = {n: float(np.mean(v))
                                  for n, v in full_share.items()}

    # se3.inverse's translation: -einsum("ij,j->i", R^T, t), one pose a
    # call; beside the formulas, the torch ops einsum may lower to
    ops = {"mv": lambda Rt, t: torch.mv(Rt, t),
           "matmul": lambda Rt, t: Rt @ t,
           "bmm": lambda Rt, t: torch.bmm(Rt[None], t[None, :, None])[0, :, 0],
           "bmm_contiguous": lambda Rt, t: torch.bmm(
               Rt.contiguous()[None], t.contiguous()[None, :, None])[0, :, 0],
           "vec_matmul": lambda Rt, t: t @ Rt.T,
           "mul_sum": lambda Rt, t: (Rt * t).sum(-1)}
    Rs, ts, want, by_op = [], [], [], {name: [] for name in ops}
    for _ in range(512):
        xi = rng.normal(size=6) * np.array([2.0, 2.0, 2.0, 1.0, 1.0, 1.0])
        T = se3.exp(torch.as_tensor(xi, dtype=torch.float32, device=dev))
        R, t = T[:3, :3], T[:3, 3]
        Rs.append(R)
        ts.append(t)
        want.append(se3.inverse(T)[:3, 3])
        for name, op in ops.items():
            by_op[name].append(-op(R.transpose(-1, -2), t))
    Rs, ts, want = torch.stack(Rs), torch.stack(ts), torch.stack(want)
    op_share = {name: share(want, torch.stack(v)) for name, v in
                by_op.items()}
    for i in range(3):
        cands = dots([Rs[:, k, i] for k in range(3)],
                     [ts[:, k] for k in range(3)])
        for name, c in cands.items():
            bias_share.setdefault(name, []).append(share(want[:, i], -c))
    result["inverse_translation"] = {n: float(np.mean(v))
                                     for n, v in bias_share.items()}
    result["inverse_translation_ops"] = op_share

    # the projection of camera.project: x / safe_z * fx + cx
    fx, cx = 525.0, 319.5
    T_cw = se3.inverse(poses[0])
    pc = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    u = pc[..., 0] / safe_z * fx + cx
    q = dvd(pc[..., 0], safe_z)
    fxt = torch.tensor(np.float32(fx), device=dev)
    cxt = torch.tensor(np.float32(cx), device=dev)
    result["project"] = {"div_mul_add": share(u, add(mul(q, fxt), cxt)),
                         "div_fma": share(u, fma(q, fxt, cxt)),
                         "div": share(pc[..., 0] / safe_z, q)}

    # the smoothing's acc / clamp(cnt, 1)
    acc = f32(torch.rand(2 ** 20, device=dev, dtype=torch.float64) * 20)
    cnt = torch.randint(1, 10, (2 ** 20,), device=dev).to(torch.float32)
    result["smooth_quotient"] = {
        "div": share(acc / torch.clamp(cnt, min=1.0), dvd(acc, cnt))}
    result.update(fuse_ops(torch, dev, rng, se3, _local_offsets, share, dots,
                           mul, add, fma, dvd, f32))
    result.update(alloc_ops(torch, dev, rng, se3, share, dots, mul, add, fma,
                            dvd, f32))
    result.update(march_ops(torch, dev, rng, se3, share, dots, mul, add, fma,
                            dvd, f32))
    result.update(dense_ops(torch, dev, rng, se3, share, dots, mul, add, fma,
                            dvd, f32))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for op, cands in result.items():
        best = max(cands, key=cands.get)
        print(f"{op:22s} best {best:12s} {cands[best]:.9f}", flush=True)
    print(json.dumps(result))
    return 0


# the flagship's fusion constants (config.flagship_config)
VOXEL, BLOCK, TRUNC, TRUNC_SCALE = 0.02, 8, 0.08, 0.01
DEPTH_MIN, DEPTH_MAX, FX, MARGIN = 0.1, 4.0, 517.3, 4.0
# row counts the fuse kernels' products run at: K6 the whole table, K7 the
# step's ~770 visible rows and the max_active ceiling, 512 voxels a row
FUSE_ROWS = {"k6_table": 262144, "k7_step": 770 * 512,
             "k7_max_active": 4096 * 512}


def fuse_ops(torch, dev, rng, se3, local_offsets, share, dots, mul, add, fma,
             dvd, f32) -> dict:
    """The ops that compaction (``block_in_frustum``) and integration
    (``project_rows``, ``_integrate_rows``, ``sample_weight``) run, as
    ops/hash_ops.py and ops/tsdf.py write them, against candidate orders
    of float32 operations: {op: {candidate: share}}."""
    out = {}

    def c32(x: float):
        return torch.tensor(np.float32(x), device=dev)

    # block2world + half, then the (N, 3) @ (3, 3) product and its bias
    # at the sizes K6 and K7 give it (the library may pick its kernel by N)
    half = 0.5 * BLOCK * VOXEL
    blocks = torch.as_tensor(rng.integers(-120, 120, (4096, 3)),
                             dtype=torch.int32, device=dev)
    vox = blocks * BLOCK
    center = (vox.to(torch.int32).to(torch.float32) * VOXEL + half)
    out["block_center"] = {"mul_add": share(center, add(mul(
        vox.to(torch.float32), c32(VOXEL)), c32(half)))}
    world = ((blocks[:, None, :] * BLOCK + local_offsets(BLOCK, device=dev))
             .to(torch.float32) * VOXEL).reshape(-1, 3)
    for k, (name, n) in enumerate(FUSE_ROWS.items()):
        xi = rng.normal(size=6) * np.array([1.5, 1.5, 1.5, 0.8, 0.8, 0.8])
        T_cw = se3.inverse(se3.exp(torch.as_tensor(
            xi, dtype=torch.float32, device=dev)))
        rows = world[:n]
        pc = se3.apply(T_cw, rows)
        M = T_cw[:3, :3].T
        shares = {}
        for j in range(3):
            cands = dots([rows[:, i] for i in range(3)],
                         [M[i, j] for i in range(3)])
            for cname, c in cands.items():
                shares.setdefault(cname, []).append(
                    share(pc[:, j], add(c, T_cw[j, 3])))
        out[f"matmul_plus_bias_{name}"] = {
            c: float(np.mean(v)) for c, v in shares.items()}

    # z-adaptive margin: margin_px + radius * fx / zm, the Python double
    # radius * fx over a tensor (Tensor.__rtruediv__)
    z = f32(torch.rand(2 ** 20, device=dev, dtype=torch.float64) * 6 - 1)
    zm = torch.clamp(z, min=0.05)
    rf = half * 1.7320508 * FX
    got = MARGIN + rf / zm
    one = c32(1.0)
    out["margin"] = {
        "rcp_mul_add": share(got, add(mul(dvd(one, zm), c32(rf)),
                                      c32(MARGIN))),
        "div_add": share(got, add(dvd(c32(rf), zm), c32(MARGIN)))}
    out["clamp_min"] = {"max_f32": share(
        torch.clamp(z, min=1e-6), torch.maximum(z, c32(1e-6)))}

    # a float32 tensor against a Python double that float32 does not hold:
    # the neighbours of float32(t), compared as float32 or as float64
    cmp = {"f32": [], "f64": []}
    for t in (DEPTH_MIN - 2 * half, DEPTH_MAX + 2 * half, 1e-6, 0.3):
        base = np.float32(t)
        xs = [base]
        for _ in range(3):
            xs = ([np.nextafter(xs[0], np.float32(-np.inf))] + xs
                  + [np.nextafter(xs[-1], np.float32(np.inf))])
        x = torch.as_tensor(np.array(xs, np.float32), device=dev)
        for op in (torch.gt, torch.lt, torch.ge, torch.le):
            got = op(x, t)
            cmp["f32"].append(bool(torch.equal(got, op(x, c32(t)))))
            cmp["f64"].append(bool(torch.equal(
                got, op(x.double(), torch.tensor(t, dtype=torch.float64,
                                                 device=dev)))))
    out["compare_double"] = {k: float(np.mean(v)) for k, v in cmp.items()}

    # trunc = truncation + trunc_scale * depth; sample_weight's chain
    from voxelhashing_demo_tpu_torch.config import CameraConfig, FusionConfig
    from voxelhashing_demo_tpu_torch.geometry.f32 import recip
    from voxelhashing_demo_tpu_torch.ops.tsdf import sample_weight

    depth = f32(torch.rand(2 ** 20, device=dev, dtype=torch.float64) * 4.2)
    trunc = TRUNC + TRUNC_SCALE * depth
    out["trunc"] = {
        "mul_add": share(trunc, add(mul(depth, c32(TRUNC_SCALE)),
                                    c32(TRUNC))),
        "fma": share(trunc, fma(depth, c32(TRUNC_SCALE), c32(TRUNC)))}
    cam = CameraConfig(depth_min=DEPTH_MIN, depth_max=DEPTH_MAX)
    fusion = FusionConfig(voxel_size=VOXEL, truncation=TRUNC)
    d01 = torch.clamp(mul(add(depth, c32(-DEPTH_MIN)),
                          c32(recip(DEPTH_MAX - DEPTH_MIN))), 0.0, 1.0)
    want = torch.maximum(mul(c32(fusion.weight_sample * 1.5),
                             add(one, -d01)), one)
    out["sample_weight"] = {"in_order": share(
        sample_weight(depth, cam, fusion), want)}

    # the running-average update and its inverse, as _integrate_rows
    # writes them (four roundings and an IEEE divide, no FMA)
    n = 2 ** 20
    old_sdf = f32((torch.rand(n, device=dev, dtype=torch.float64) - 0.5)
                  * 0.24)
    old_w = f32(torch.rand(n, device=dev, dtype=torch.float64) * 300)
    old_w = torch.where(old_w > 255, 255.0, old_w)
    sdf = f32((torch.rand(n, device=dev, dtype=torch.float64) - 0.5) * 0.2)
    w_new = f32(1.0 + torch.rand(n, device=dev, dtype=torch.float64) * 0.5)
    w_sum = old_w + w_new
    got = (old_sdf * old_w + sdf * w_new) / torch.clamp(w_sum, min=1e-12)
    num = add(mul(old_sdf, old_w), mul(sdf, w_new))
    out["update"] = {
        "in_order": share(got, dvd(num, torch.maximum(
            add(old_w, w_new), c32(1e-12)))),
        "fma_num": share(got, dvd(fma(sdf, w_new, mul(old_sdf, old_w)),
                                  torch.maximum(add(old_w, w_new),
                                                c32(1e-12))))}
    w_rem = torch.clamp(old_w - w_new, min=0.0)
    got = (old_sdf * old_w - sdf * w_new) / torch.clamp(w_rem, min=1e-12)
    rem = torch.maximum(add(old_w, -w_new), c32(0.0))
    out["inverse_update"] = {"in_order": share(got, dvd(
        add(mul(old_sdf, old_w), -mul(sdf, w_new)),
        torch.maximum(rem, c32(1e-12))))}
    return out


# candidate keys a frame: band steps x strided pixels, at 80x60 stride 1,
# 640x480 stride 3 (the flagship), stride 2 (the CLI) and stride 1
ALLOC_ROWS = {"tiny_s1": 3 * 60 * 80, "flagship_s3": 3 * 160 * 214,
              "cli_s2": 3 * 240 * 320, "full_s1": 3 * 480 * 640}


def alloc_ops(torch, dev, rng, se3, share, dots, mul, add, fma, dvd,
              f32) -> dict:
    """The ops of ``frame_candidate_keys_reference`` (ops/hash_ops.py) on
    a strided 640x480 vertex map and at the candidate counts of the
    configs, against candidate orders of float32 operations: {op:
    {candidate: share}}."""
    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.geometry.f32 import recip

    out = {}

    def c32(x: float):
        return torch.tensor(np.float32(x), device=dev)

    # a vertex map as the frontend gives it: z in 0.3-4 m, x and y the
    # back-projection through the flagship camera; the stride-3 view
    H, W, fx, fy, cx, cy = 480, 640, 517.3, 516.5, 318.6, 255.3
    z = f32(0.3 + torch.rand(H, W, device=dev, dtype=torch.float64) * 3.7)
    v, u = torch.meshgrid(torch.arange(H, device=dev),
                          torch.arange(W, device=dev), indexing="ij")
    verts = torch.stack([f32((u - cx) / fx) * z, f32((v - cy) / fy) * z, z],
                        -1)
    for stride in (1, 3):
        x = verts[::stride, ::stride]
        sq = x * x
        got = torch.sum(sq, dim=-1)
        out[f"norm_sum_s{stride}"] = {
            "x0x2_x1": share(got, add(add(sq[..., 0], sq[..., 2]),
                                      sq[..., 1])),
            "x0x1_x2": share(got, add(add(sq[..., 0], sq[..., 1]),
                                      sq[..., 2]))}
    x = verts[::3, ::3]
    ray_len = torch.sqrt(torch.sum(x * x, dim=-1))
    got = 1.0 / torch.clamp(ray_len, min=1e-9)
    out["inv_len"] = {"rcp": share(got, dvd(c32(1.0), torch.maximum(
        ray_len, c32(1e-9))))}

    # torch.linspace(-1, 1, n): its CUDA kernel's start + step * i below
    # the halfway index and end - step * (n - 1 - i) from it, fused or not
    lin = {"fma": [], "mul_add": []}
    for n in range(2, 17):
        got = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=dev)
        step = dvd(c32(2.0), c32(n - 1))
        i = torch.arange(n, device=dev).to(torch.float32)
        low = i < n // 2
        one = c32(1.0)
        want_fma = torch.where(low, fma(step, i, -one),
                               fma(-step, (n - 1) - i, one))
        want_ma = torch.where(low, add(mul(step, i), -one),
                              add(-mul(step, (n - 1) - i), one))
        lin["fma"].append(bool(torch.equal(got.view(torch.int32),
                                           want_fma.view(torch.int32))))
        lin["mul_add"].append(bool(torch.equal(got.view(torch.int32),
                                               want_ma.view(torch.int32))))
    out["linspace"] = {k: float(np.mean(v)) for k, v in lin.items()}

    # the band sample verts + ray_dir * (step * trunc) and world2voxel's
    # p * recip(voxel) + -0.5 / 0.5, truncated
    d = x[..., 2]
    inv = 1.0 / torch.clamp(ray_len, min=1e-9)
    ray = x * inv[..., None]
    trunc = 0.08 + 0.01 * d
    st = -1.0 * trunc
    got = x + ray * st[..., None]
    out["band_sample"] = {"in_order": share(got, add(x, mul(
        ray, st[..., None])))}
    p = got * recip(0.02)
    vox = coords.world2voxel(got, 0.02)
    want = torch.trunc(add(mul(got, c32(recip(0.02))),
                           torch.where(p >= 0, c32(0.5), c32(-0.5))))
    out["world2voxel"] = {"mul_add_trunc": float(
        (vox == want.to(torch.int32)).float().mean())}

    # se3.apply(T_wc, samples): the (M, 3) @ (3, 3)^T product and + t at
    # each config's candidate count
    pts_all = f32((torch.rand(ALLOC_ROWS["full_s1"], 3, device=dev,
                              dtype=torch.float64) - 0.5) * 8)
    for name, n in ALLOC_ROWS.items():
        xi = rng.normal(size=6) * np.array([1.5, 1.5, 1.5, 0.8, 0.8, 0.8])
        T = se3.exp(torch.as_tensor(xi, dtype=torch.float32, device=dev))
        rows = pts_all[:n]
        pc = se3.apply(T, rows)
        M = T[:3, :3].T
        shares = {}
        for j in range(3):
            cands = dots([rows[:, i] for i in range(3)],
                         [M[i, j] for i in range(3)])
            for cname, c in cands.items():
                shares.setdefault(cname, []).append(
                    share(pc[:, j], add(c, T[j, 3])))
        out[f"apply_{name}"] = {c: float(np.mean(v))
                                for c, v in shares.items()}
    return out


def march_ops(torch, dev, rng, se3, share, dots, mul, add, fma, dvd,
              f32) -> dict:
    """The ops of ``raycast_rays_reference`` (ops/raycast.py) that K11
    repeats: ``rays_cam @ R.T`` (the right operand a transposed view of
    the pose's rotation) on the flagship's pixel rays and on a row slice
    of them (the sharded shape), ``1.0 / _norm(dirs)`` and
    ``torch.reciprocal``, and ``n_world @ R``; on random poses, on the
    identity and on axis permutations with signs (exact zeros in R), and
    for ``n_world`` on random unit vectors and on axis-aligned ones.
    Beside the matmul's candidate orders, ``fma0_012`` starts the sum from
    fma(a0, b0, +0) instead of the rounded product: it differs only in
    the sign of an exact zero.  {op: {candidate: share}}."""
    from voxelhashing_demo_tpu_torch.config import CameraConfig
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops.preprocess import _norm

    out = {}
    zero = torch.zeros((), device=dev)
    rays = cam_geom.pixel_rays(CameraConfig(), device=dev)   # (480, 640, 3)
    poses = [torch.eye(4, device=dev)]
    for perm, signs in (((1, 2, 0), (1, -1, -1)), ((0, 2, 1), (-1, 1, 1)),
                        ((2, 0, 1), (-1, -1, 1))):
        T = torch.zeros(4, 4, device=dev)
        for i, (j, sgn) in enumerate(zip(perm, signs)):
            T[i, j] = sgn
        T[3, 3] = 1.0
        if torch.linalg.det(T[:3, :3]) < 0:
            T[2] = -T[2]
            T[3, 3] = 1.0
        poses.append(T)
    for _ in range(12):
        xi = rng.normal(size=6) * np.array([1.5, 1.5, 1.5, 0.8, 0.8, 0.8])
        poses.append(se3.exp(torch.as_tensor(xi, dtype=torch.float32,
                                             device=dev)))

    def candidates(a, b, j):
        """every order of a_k b_kj, plus fma0_012"""
        cands = dots([a[..., k] for k in range(3)], [b[k] for k in range(3)])
        cands["fma0_012"] = fma(a[..., 2], b[2], fma(a[..., 1], b[1], fma(
            a[..., 0], b[0], zero)))
        return cands

    for name, r in (("rays_RT", rays), ("rays_RT_slice", rays[120:360])):
        shares = {}
        for T in poses:
            R = T[:3, :3]
            got = r @ R.T
            for j in range(3):
                for cname, c in candidates(r, [R[j, k] for k in range(3)],
                                           j).items():
                    shares.setdefault(cname, []).append(
                        share(got[..., j], c))
        out[name] = {c: float(np.mean(v)) for c, v in shares.items()}

    # the inverse ray length: 1.0 / _norm(dirs) (Tensor.__rtruediv__) and
    # torch.reciprocal, against an IEEE divide of the float32 norm
    inv, rcp = [], []
    for T in poses:
        dirs = rays @ T[:3, :3].T
        n = _norm(dirs)
        inv.append(share(1.0 / n, dvd(torch.ones_like(n), n)))
        rcp.append(share(torch.reciprocal(n), dvd(torch.ones_like(n), n)))
    out["march_inv_len"] = {"ieee_div": float(np.mean(inv))}
    out["reciprocal"] = {"ieee_div": float(np.mean(rcp))}

    # n_world @ R on random unit vectors and on axis-aligned ones (exact
    # zeros; signs both ways), the row count of a 640 x 480 image
    g = f32(torch.randn(480 * 640, 3, device=dev, dtype=torch.float64))
    units = g / _norm(g, keepdim=True)
    axes = torch.zeros(480 * 640, 3, device=dev)
    pick = torch.randint(0, 3, (480 * 640,), device=dev)
    sign = torch.where(torch.rand(480 * 640, device=dev) < 0.5, -1.0, 1.0)
    axes[torch.arange(480 * 640, device=dev), pick] = sign
    for name, nw in (("n_world_R", units), ("n_world_R_axes", axes)):
        shares = {}
        for T in poses:
            R = T[:3, :3]
            got = nw @ R
            for j in range(3):
                for cname, c in candidates(nw, [R[k, j] for k in range(3)],
                                           j).items():
                    shares.setdefault(cname, []).append(
                        share(got[..., j], c))
        out[name] = {c: float(np.mean(v)) for c, v in shares.items()}
    return out


def dense_ops(torch, dev, rng, se3, share, dots, mul, add, fma,
              dvd, f32) -> dict:
    """The ops of ``integrate_dense_reference`` (ops/tsdf.py) that K20
    repeats, as it writes them, on the grid, fusion settings and camera of
    chip_smoke.py's ``dense`` phase (``dense_config``) and the orbit's 20
    poses (its frames' poses) plus 4 random ones: the voxel centres
    ``origin + grid * voxel_size`` (the voxel size a 0-d tensor),
    ``se3.inverse``'s translation, ``world @ T_cw[:3, :3].T + t`` on the
    4-D grid (3 276 800 rows; on the card also on the phase's
    ``DENSE_BIG``^3 volume, 2^27 rows, only the candidate K20 uses),
    ``x / z * fx + cx``, ``truncation + trunc_scale * depth``, ``(depth -
    depth_min) * recip(...)`` and ``weight_sample * 1.5 * (1 - d01)``
    (the left product in double), and the running average: {op:
    {candidate: share}}."""
    import chip_smoke as cs
    from voxelhashing_demo_tpu_torch.geometry.f32 import recip
    from voxelhashing_demo_tpu_torch.ops import tsdf
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = cs.dense_config()
    cam, fusion, grid = cfg.camera, cfg.fusion, cfg.grid
    out = {}

    def c32(x: float):
        return torch.tensor(np.float32(x), device=dev)

    poses = [torch.as_tensor(synthetic.orbit_pose(i / 19, 0.05, 2.5),
                             dtype=torch.float32, device=dev)
             for i in range(20)]
    for _ in range(4):
        xi = rng.normal(size=6) * np.array([1.5, 1.5, 1.5, 0.8, 0.8, 0.8])
        poses.append(se3.exp(torch.as_tensor(xi, dtype=torch.float32,
                                             device=dev)))
    state = tsdf.DenseTSDF(
        sdf=torch.zeros(grid.dims, device=dev),
        weight=torch.zeros(grid.dims, device=dev),
        origin=torch.tensor(grid.origin, dtype=torch.float32, device=dev),
        voxel_size=torch.tensor(fusion.voxel_size, dtype=torch.float32,
                                device=dev))
    world = tsdf.voxel_world_positions(state)
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=dev, dtype=torch.float64)
          for n in grid.dims), indexing="ij"), dim=-1)
    out["dense_centre"] = {
        "mul_add": share(world, add(state.origin, mul(
            idx, state.voxel_size))),
        "fma": share(world, fma(idx, state.voxel_size, state.origin))}

    # se3.inverse's translation at the phase's poses
    inv = {}
    for T in poses:
        R, t = T[:3, :3], T[:3, 3]
        want = se3.inverse(T)[:3, 3]
        for i in range(3):
            cands = dots([R[k, i] for k in range(3)], [t[k] for k in range(3)])
            for name, c in cands.items():
                inv.setdefault(name, []).append(share(want[i], -c))
    out["dense_inverse_translation"] = {n: float(np.mean(v))
                                        for n, v in inv.items()}

    # se3.apply on the 4-D grid, then the projection of its camera points
    mm, proj = {}, {"div_mul_add": [], "div_fma": []}
    fx, cx = c32(cam.fx), c32(cam.cx)
    for T in poses:
        T_cw = se3.inverse(T)
        pc = se3.apply(T_cw, world)
        M = T_cw[:3, :3].T
        for j in range(3):
            cands = dots([world[..., i] for i in range(3)],
                         [M[i, j] for i in range(3)])
            for name, c in cands.items():
                mm.setdefault(name, []).append(
                    share(pc[..., j], add(c, T_cw[j, 3])))
        z = pc[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
        u = pc[..., 0] / safe_z * cam.fx + cam.cx
        q = dvd(pc[..., 0], safe_z)
        proj["div_mul_add"].append(share(u, add(mul(q, fx), cx)))
        proj["div_fma"].append(share(u, fma(q, fx, cx)))
    out["dense_apply_4d"] = {n: float(np.mean(v)) for n, v in mm.items()}
    out["dense_project"] = {n: float(np.mean(v)) for n, v in proj.items()}
    del world, idx, pc

    if dev.type == "cuda":
        # the large volume: the product K20 uses, a column at a time
        big = cs.DENSE_BIG
        vs = cs.DENSE_BIG_EDGE_M / big
        bstate = state._replace(
            sdf=torch.empty((big, big, big), device=dev),
            origin=torch.tensor(cs.DENSE_BIG_ORIGIN, dtype=torch.float32,
                                device=dev),
            voxel_size=torch.tensor(vs, dtype=torch.float32, device=dev))
        bworld = tsdf.voxel_world_positions(bstate)
        shares = []
        for T in poses[::6]:
            T_cw = se3.inverse(T)
            pc = se3.apply(T_cw, bworld)
            M = T_cw[:3, :3].T
            for j in range(3):
                c = fma(bworld[..., 2], M[2, j], fma(
                    bworld[..., 1], M[1, j],
                    mul(bworld[..., 0], M[0, j])))
                shares.append(share(pc[..., j], add(c, T_cw[j, 3])))
                del c
            del pc
        out[f"dense_apply_4d_{big}"] = {"fma_012": float(np.mean(shares))}
        del bworld, bstate

    # the truncation band, sample_weight's chain and the update, on the
    # depths of a frame of the orbit
    depth = synthetic.make_sequence(cam, 1, as_raw=False, device=dev)[0][0]
    depth = depth.reshape(-1)
    trunc = fusion.truncation + fusion.trunc_scale * depth
    out["dense_trunc"] = {
        "mul_add": share(trunc, add(mul(depth, c32(fusion.trunc_scale)),
                                    c32(fusion.truncation))),
        "fma": share(trunc, fma(depth, c32(fusion.trunc_scale),
                                c32(fusion.truncation)))}
    one = c32(1.0)
    d01 = torch.clamp(mul(add(depth, c32(-cam.depth_min)),
                          c32(recip(cam.depth_max - cam.depth_min))),
                      0.0, 1.0)
    got = tsdf.sample_weight(depth, cam, fusion)
    out["dense_sample_weight"] = {
        "double_product": share(got, torch.maximum(mul(
            c32(fusion.weight_sample * 1.5), add(one, -d01)), one)),
        "f32_products": share(got, torch.maximum(mul(mul(
            c32(fusion.weight_sample), c32(1.5)), add(one, -d01)), one))}
    n = depth.numel()
    old_sdf = f32((torch.rand(n, device=dev, dtype=torch.float64) - 0.5)
                  * 0.16)
    old_w = f32(torch.rand(n, device=dev, dtype=torch.float64) * 300)
    old_w = torch.where(old_w > 255, 255.0, old_w)
    sdf = torch.clamp(depth - f32(torch.rand(n, device=dev,
                                             dtype=torch.float64) * 4),
                      -fusion.truncation, fusion.truncation)
    w_new = got
    w_sum = old_w + w_new
    fused = (old_sdf * old_w + sdf * w_new) / torch.clamp(w_sum, min=1e-12)
    den = torch.maximum(add(old_w, w_new), c32(1e-12))
    out["dense_update"] = {
        "in_order": share(fused, dvd(add(mul(old_sdf, old_w),
                                         mul(sdf, w_new)), den)),
        "fma_num": share(fused, dvd(fma(sdf, w_new, mul(old_sdf, old_w)),
                                    den))}
    return out


if __name__ == "__main__":
    sys.exit(main())
