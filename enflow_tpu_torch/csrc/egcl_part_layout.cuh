// The float32 partials of the all-pairs EGCL backward's nine parameter
// gradients, one slice per block (egcl_allpairs_f32.cu) or per warpgroup
// (egcl_allpairs_sm90.cu); ops/egcl_allpairs.py sums the slices' first P
// floats and splits the sum (_split_part).
//
// Offsets in a slice: dW2, dW3 [H, H] first (read and written in place a
// float4 or more at a time, which needs their alignment), then dW1a, dW1b
// [nf, H], dw1r, db1, db2, db3, dw4 [H]; P is rounded up to 8 floats so
// that every slice is aligned too.

#pragma once

struct PartLayout {
  int dW2, dW3, dW1a, dW1b, dw1r, db1, db2, db3, dw4, P;
  __host__ __device__ PartLayout(int nf, int H) {
    dW2 = 0;
    dW3 = H * H;
    dW1a = 2 * H * H;
    dW1b = dW1a + nf * H;
    dw1r = dW1b + nf * H;
    db1 = dw1r + H;
    db2 = db1 + H;
    db3 = db2 + H;
    dw4 = db3 + H;
    P = (dw4 + H + 7) / 8 * 8;
  }
};

// P: the floats of the nine gradients at the start of a slice.
extern "C" int egcl_part_size(int nf, int H) { return PartLayout(nf, H).P; }
