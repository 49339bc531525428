#!/usr/bin/env python3
"""How PyTorch's CUDA ops round the float32 arithmetic that the splat
kernel K8 (csrc/splat.cu) repeats, bit for bit, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_rounding_probe.py [--rows 2048]

For each op the plain splat runs (``ops/splat.py``: ``voxel2world``, the
(N, 3) @ (3, 3) product and its bias, ``se3.inverse``'s einsum (and
the torch ops it may lower to), the
projection ``x / z * fx + cx``, and the smoothing's quotient) it prints
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
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for op, cands in result.items():
        best = max(cands, key=cands.get)
        print(f"{op:22s} best {best:12s} {cands[best]:.9f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
