#!/bin/bash
# Does NVIDIA's compute-sanitizer run on this machine's card?
#
# Builds a ten-line CUDA program whose kernel writes one element past its
# buffer, runs it plainly, then under each compute-sanitizer tool.  Where
# the tools work, memcheck reports the write (exit 7) and the others exit
# 0; where they do not, each tool prints its refusal ("Device not
# supported") and the program's CUDA calls fail.  ROADMAP 1.5.1 keeps the
# port's compute-sanitizer pass open until this probe shows the tools run.
#
#     bash scripts/compute_sanitizer_probe.sh      # on a machine with a card
set -u
CUDA=${CUDA_HOME:-/usr/local/cuda}
CS=$CUDA/bin/compute-sanitizer
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
nvidia-smi --query-gpu=name,power.limit,driver_version --format=csv,noheader
if [ ! -x "$CS" ]; then
    echo "no compute-sanitizer at $CS"
    exit 1
fi
"$CS" --version | tail -1
cat > "$WORK/probe.cu" <<'EOF'
#include <cstdio>
__global__ void add_one(float* a, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= n) a[i] += 1.f;  // i == n writes one element past the buffer
}
int main() {
  float* a = nullptr;
  cudaError_t e = cudaMalloc(&a, 100 * sizeof(float));
  printf("cudaMalloc: %s\n", cudaGetErrorString(e));
  add_one<<<1, 128>>>(a, 100);
  printf("kernel: %s\n", cudaGetErrorString(cudaDeviceSynchronize()));
  return 0;
}
EOF
"$CUDA/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -o "$WORK/probe" \
    "$WORK/probe.cu" || exit 1
echo "--- plain run"
"$WORK/probe"
for tool in memcheck racecheck synccheck initcheck; do
    echo "--- $tool"
    timeout 120 "$CS" --tool "$tool" --error-exitcode 7 --print-limit 5 \
        "$WORK/probe" 2>&1 | head -12
    echo "exit ${PIPESTATUS[0]}"
done
