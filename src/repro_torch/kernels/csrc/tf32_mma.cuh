// Split-TF32 tensor-core products (mma.sync.m16n8k8), shared by the
// attention forward (flash_attn.cu) and backward (flash_attn_bwd.cu).
//
// An f32 x is hi + lo: hi x rounded to TF32 by integer add and mask (no
// cvt), lo = x - hi exactly. A product takes a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi in f32 accumulators, about f32's accuracy (one pass of TF32
// keeps three digits). Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
// A (row-major 16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g,
// 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once

// x = hi + lo: hi x rounded to TF32 (10 mantissa bits, ties away), lo the
// exact rest, whose low bits the tensor core drops.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b with a = a_hi + a_lo and b f32 (split too) or exact in TF32
// (fp16, bf16: b_lo = 0), small terms first.
template <bool kSplitB>
__device__ __forceinline__ void mma3(float c[4], const unsigned ahi[4], const unsigned alo[4],
                                     float b0, float b1) {
  if (kSplitB) {
    unsigned b0h, b0l, b1h, b1l;
    split_tf32(b0, b0h, b0l);
    split_tf32(b1, b1h, b1l);
    mma(c, alo, b0h, b1h);
    mma(c, ahi, b0l, b1l);
    mma(c, ahi, b0h, b1h);
  } else {
    const unsigned b0h = __float_as_uint(b0), b1h = __float_as_uint(b1);
    mma(c, alo, b0h, b1h);
    mma(c, ahi, b0h, b1h);
  }
}

// c += a * b with both split ahead of the product (b's halves read from a
// hi and a lo tile, where each element was split once), small terms first:
// the same three passes as mma3<true>.
__device__ __forceinline__ void mma3s(float c[4], const unsigned ahi[4], const unsigned alo[4],
                                      unsigned bh0, unsigned bh1, unsigned bl0, unsigned bl1) {
  mma(c, alo, bh0, bh1);
  mma(c, ahi, bl0, bl1);
  mma(c, ahi, bh0, bh1);
}
