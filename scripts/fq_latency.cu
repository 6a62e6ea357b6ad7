// Latency and throughput of the Fq products and the XYZZ doubling of
// csrc/field.cuh and csrc/curve.cuh on one CUDA card: a chain of dependent
// products in one thread (what the window ladder and the tops of the
// reduction trees pay) and independent chains on every SM (what the bucket
// accumulation pays), for the PTX carry-chain product (fq_mul) and the C
// CIOS product (zk_mul<Fq>), and the window ladder's warp doubling.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/fq_latency scripts/fq_latency.cu && build/fq_latency
#include <cstdio>

#include "../aes_zero_knowledge_proof_circuit_tpu_torch/csrc/curve.cuh"

namespace {

template <bool kPtx>
__global__ void mul_chain(uint32_t* x, int n, int chains) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[12], c[12], b[12];
  for (int j = 0; j < 12; ++j) {
    a[j] = x[j + 12 * (t % 4)];
    c[j] = x[24 + j];
    b[j] = x[12 + j];
  }
  for (int k = 0; k < n; ++k) {
    fmul<kPtx>(a, a, b);
    if (chains == 2) fmul<kPtx>(c, c, b);
  }
  for (int j = 0; j < 12; ++j) x[64 + 12 * t + j] = a[j] ^ c[j];
}

template <bool kPtx>
__global__ void dbl_chain(uint32_t* x, int n) {
  Xyzz p;
  load_pt(p, x);
  for (int k = 0; k < n; ++k) xyzz_dbl<kPtx>(p);
  store_pt(x + 64, p);
}

__global__ void dbl_chain_warp(uint32_t* x, int n) {
  Xyzz p;
  load_pt(p, x);
  for (int k = 0; k < n; ++k) xyzz_dbl_warp(p);
  if (threadIdx.x == 0) store_pt(x + 64, p);
}

}  // namespace

int main() {
  uint32_t* x;
  cudaMalloc(&x, 64 << 20);
  cudaMemset(x, 1, 64 << 20);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto run = [&](const char* name, auto launch) {
    launch();
    cudaDeviceSynchronize();
    float ms = 0;
    cudaEventRecord(e0);
    launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("%s: %.3f ms (%s)\n", name, ms,
           cudaGetErrorString(cudaGetLastError()));
  };
  run("1 thread, 1000 products, PTX", [&] { mul_chain<true><<<1, 1>>>(x, 1000, 1); });
  run("1 thread, 1000 products, C", [&] { mul_chain<false><<<1, 1>>>(x, 1000, 1); });
  run("1 thread, 2 chains of 1000, PTX", [&] { mul_chain<true><<<1, 1>>>(x, 1000, 2); });
  run("1 thread, 2 chains of 1000, C", [&] { mul_chain<false><<<1, 1>>>(x, 1000, 2); });
  run("1 thread, 256 doublings, PTX", [&] { dbl_chain<true><<<1, 1>>>(x, 256); });
  run("1 thread, 256 doublings, C", [&] { dbl_chain<false><<<1, 1>>>(x, 256); });
  run("1 warp, 256 doublings over 4 lanes, C", [&] { dbl_chain_warp<<<1, 32>>>(x, 256); });
  run("132 x 1024 threads, 100 products, PTX", [&] { mul_chain<true><<<132 * 8, 128>>>(x, 100, 1); });
  run("132 x 1024 threads, 100 products, C", [&] { mul_chain<false><<<132 * 8, 128>>>(x, 100, 1); });
  return 0;
}
