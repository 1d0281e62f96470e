// RPR003 fixture: `double` in the code of a hot CUDA source.
// near miss: "double" in a comment, as in a double-buffered ring
/* near miss: double
   in a block comment */
__global__ void widen(const float* a, double* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const char* name = "double";  // near miss: a string literal
  if (i < n) out[i] = a[i];
}

__global__ void keep(const float* a, float* out, int n) {  // near miss
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmul_rn(a[i], 2.0f);
}
