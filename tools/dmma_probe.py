#!/usr/bin/env python3
"""Rates of the instructions a stacked 1D contraction on the f64 tensor
cores is made of, on the card.

    python3 tools/dmma_probe.py

Builds a small CUDA source (written here, nothing of the port's) with one
kernel per probe, launches each on every SM with 8 warps a block and two
blocks an SM, and reads the cycles each block takes with ``clock64()``.
Prints, per probe, the results per clock cycle per SM:

    ffma       f32 FMAs, 8 independent chains a thread
    dfma       f64 FMAs, the same
    cvt        f32 -> f64 -> f32 conversions (cvt.f64.f32, cvt.rn.f32.f64),
               8 independent chains a thread, each conversion counted
    dmma       mma.sync.m16n8k4 f64 products, 4 independent accumulators a
               warp (FMAs: 512 a product)
    dmma_lat   the same with one accumulator: cycles per product of one
               warp (its latency)
    lds_sts    four 4-byte shared-memory loads and a store a thread
               (results: loads and stores)

with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_ITER = 4096
THREADS = 256

SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a0), "d"(a1), "d"(b));
}

// every kernel: n iterations; thread 0 writes the block's cycles, and
// every thread a value that depends on its work
__global__ void ffma(int n, float s, long long* cyc, float* sink) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], s, 1.0f);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float r = 0.f;
  for (int i = 0; i < 8; ++i) r += x[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

__global__ void dfma(int n, float s, long long* cyc, float* sink) {
  double x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = fma(x[i], (double)s, 1.0);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  double r = 0.0;
  for (int i = 0; i < 8; ++i) r += x[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = (float)r;
}

__global__ void cvt(int n, float s, long long* cyc, float* sink) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * s + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      double d;
      asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x[i]));
      asm volatile("cvt.rn.f32.f64 %0, %1;" : "=f"(x[i]) : "d"(d));
    }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float r = 0.f;
  for (int i = 0; i < 8; ++i) r += x[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

__global__ void dmma_tp(int n, float s, long long* cyc, float* sink) {
  double c[4][4] = {};
  const double a0 = threadIdx.x * s, a1 = a0 + 1.0, b = s;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < 4; ++i) dmma(c[i], a0, a1, b);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  double r = 0.0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) r += c[i][j];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = (float)r;
}

__global__ void dmma_lat(int n, float s, long long* cyc, float* sink) {
  double c[4] = {};
  const double a0 = threadIdx.x * s, a1 = a0 + 1.0, b = s;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it) dmma(c, a0, a1, b);
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] =
      (float)(c[0] + c[1] + c[2] + c[3]);
}

__global__ void lds_sts(int n, float s, long long* cyc, float* sink) {
  __shared__ float buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) buf[i] = i * s;
  __syncthreads();
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  int o = threadIdx.x;
  const long long t0 = clock64();
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] += buf[(o + 256 * i) & 2047];
    buf[(o + 1024) & 2047] = x[0];
    o = (o + 32) & 2047;
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x[0] + x[1] + x[2] + x[3];
}

typedef void (*probe_fn)(int, float, long long*, float*);

extern "C" int probe_launch(int which, int blocks, int threads, int n,
                            long long* cyc, float* sink) {
  const probe_fn fns[] = {ffma, dfma, cvt, dmma_tp, dmma_lat, lds_sts};
  if (which < 0 || which > 5) return 1;
  fns[which]<<<blocks, threads>>>(n, 1.0000001f, cyc, sink);
  return (int)cudaGetLastError();
}
"""

# name, results per thread and iteration (per warp for the products)
PROBES = [("ffma", 8, "FMAs"), ("dfma", 8, "FMAs"),
          ("cvt", 16, "conversions"), ("dmma", 4 * 512, "FMAs"),
          ("dmma_lat", None, "cycles per product"),
          ("lds_sts", 5, "loads and stores")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dmma_probe: no CUDA device", file=sys.stderr)
        return 2
    from ns_gls_tpu_torch.utils import cuda_build as cb

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    cu = os.path.join(cb.BUILD_DIR, "dmma_probe.cu")
    so = os.path.join(cb.BUILD_DIR, "libdmma_probe.so")
    with open(cu, "w") as f:
        f.write(SOURCE)
    out = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    lib.probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.probe_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 2 * sms
    cyc = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    sink = torch.zeros(blocks * THREADS, dtype=torch.float32, device="cuda")
    for which, (name, per_iter, unit) in enumerate(PROBES):
        for _ in range(2):          # the first launch warms up
            err = lib.probe_launch(which, blocks, THREADS, N_ITER,
                                   cyc.data_ptr(), sink.data_ptr())
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")
        cycles = float(cyc.float().mean())
        if per_iter is None:
            rec = dict(probe=name, value=cycles / N_ITER, unit=unit)
        else:
            # two blocks an SM run side by side: results of both over the
            # cycles of one
            per = THREADS if name != "dmma" else THREADS // 32
            rec = dict(probe=name,
                       value=2 * per * per_iter * N_ITER / cycles,
                       unit=f"{unit} per clock per SM")
        rec.update(card=card, block_cycles=cycles, finite=bool(
            torch.isfinite(sink).all()))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
