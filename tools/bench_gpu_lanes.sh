#!/usr/bin/env bash
# Every lane of the gls-vmult benchmark of the PyTorch/CUDA port in one go,
# on one NVIDIA GPU, from the repository root:
#
#     bash tools/bench_gpu_lanes.sh [output file]
#
# 3 5 2 in each flavor with the 3D and the batched 3D kernel, twice in turn
# (the chained apply's time moves with the host, the kernel's does not),
# then 3 6 2 (beyond L2) with both kernels, 2 9 2 (the 2D kernel) and the
# sphere on the patch-3D kernel: --sphere 3 2 (811,272 DoFs, 38 MB of
# operands, in L2) and --sphere 4 2 (6,390,280 DoFs, streaming from HBM),
# and the Turek 3D mesh on the prism kernel: --turek 3 (6,789,120 DoFs).
# Prints bench_gpu.py's own lines; with an argument, also writes them there.
set -u
out="${1:-/dev/null}"
{
for flags in "" "--increment" "--batched" "--increment --batched"; do
  for _ in 1 2; do python3 bench_gpu.py 3 5 2 $flags; done
done
python3 bench_gpu.py 3 6 2
python3 bench_gpu.py 3 6 2 --batched
python3 bench_gpu.py 2 9 2
python3 bench_gpu.py --sphere 3 2
python3 bench_gpu.py --sphere 4 2
python3 bench_gpu.py --turek 3
} 2>&1 | tee "$out"
