"""Where a step of the streaming BiLSTM forward kernel spends its time: the
bf16 kernel (clair_tpu_torch/csrc/bilstm_stream_fwd.cu) built in variants
that each cut one part of the step out, timed at fixed geometries. (The
float32 mode runs the sweep of lstm_sweep.cuh, which
tools/torch_train_fwd_sweep.py ablates.)

    python3 tools/torch_stream_fwd_ablate.py

The variants compute wrong results on purpose; only their times mean
anything, as the time the cut part costs (the base minus the variant). The
sources of the variants and their libraries go to build/stream_fwd_ablate/.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "clair_tpu_torch" / "csrc"
OUT = ROOT / "build" / "stream_fwd_ablate"

H_PRODUCT = ("""                if (step > 0)
                    product(ws, L, p.fk, hs, L.hp, p.hk, g, r0, hu);
                else
                    zero(hu);""", "                zero(hu);")
X_PRODUCT = ("                input_products(ws, L, p, xs, items, groups, xw);\n            }",
             "            }")
EXCHANGE = ("                    for (int peer = 0; peer < n_ctas; ++peer)",
            "                    for (int peer = 0; peer < 0; ++peer)")
NONLINEARITIES = [
    ("gate_sigmoid<bf16>(a_f) * c_prev +\n"
     "                                            gate_sigmoid<bf16>(a_i) * gate_tanh<bf16>(a_g);",
     "a_f * c_prev + a_i * a_g;"),
    ("from_float<bf16>(gate_sigmoid<bf16>(a_o) * gate_tanh<bf16>(c_new));",
     "from_float<bf16>(a_o * c_new);")]
OUTPUTS = [("            if (p.vec) {\n                for (int idx = threadIdx.x; idx < p.rows * chunks;",
            "            if (false) {\n                for (int idx = threadIdx.x; idx < p.rows * chunks;"),
           ("            } else {\n                for (int idx = threadIdx.x; idx < p.rows * uc;",
            "            } else if (false) {\n                for (int idx = threadIdx.x; idx < p.rows * uc;")]
X_STAGING = ("            if (step + 1 < p.t_len) stage_x(p, x, xs, L.xp, row0, dir == 0 ? t + 1 : t - 1);",
             "")
VARIANTS = {
    "base": [],
    "no h.U": [H_PRODUCT],
    "no x.W": [X_PRODUCT],
    "no h exchange": [EXCHANGE],
    "no nonlinearities": NONLINEARITIES,
    "no h_out/c_out": OUTPUTS,
    "no x staging": [X_STAGING],
    "barriers and loops only": [H_PRODUCT, X_PRODUCT, EXCHANGE, *NONLINEARITIES, *OUTPUTS,
                                X_STAGING],
}
# (F, batch, cluster, rows): the layers at the geometries the launcher
# picks for them on an H100
CASES = ((256, 512, 2, 16), (256, 10_000, 2, 16), (32, 10_000, 1, 16))


def build(name, patches):
    source = (CSRC / "bilstm_stream_fwd.cu").read_text()
    for old, new in patches:
        if old not in source:
            raise SystemExit(f"variant {name!r}: the kernel no longer has {old[:60]!r}")
        source = source.replace(old, new)
    stem = name.replace(" ", "_").replace(".", "").replace("/", "_")
    src, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    src.write_text(source)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    dev = torch.device("cuda")
    dtype = torch.bfloat16
    for feat, batch, cluster, rows in CASES:
        rs = np.random.RandomState(0)
        x = torch.tensor(rs.randn(batch, 33, feat), dtype=dtype, device=dev)
        w = torch.tensor(rs.randn(2, feat, 512) * 0.08, dtype=dtype, device=dev)
        u = torch.tensor(rs.randn(2, 128, 512) * 0.08, dtype=dtype, device=dev)
        b = torch.zeros(2, 512, dtype=torch.float32, device=dev)
        h = torch.empty(batch, 33, 256, dtype=dtype, device=dev)
        times = []
        for name, lib in libs.items():
            fn = lib.clair_bilstm_stream_fwd_geometry
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 2)

            def run(fn=fn):
                return fn(x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h.data_ptr(),
                          None, None, None, 0, batch, 33, feat, 128, 1, cluster, rows, None,
                          torch.cuda.current_stream().cuda_stream)
            if run() != 0:
                raise SystemExit(f"{name} does not launch")
            times.append(f"{name} {cuda_ms(run, 20 if batch <= 512 else 5):.4f}")
        print(f"{str(dtype)[6:]} F={feat} B={batch} cluster {cluster} rows {rows} (ms): "
              + ", ".join(times), flush=True)


if __name__ == "__main__":
    sys.exit(main())
