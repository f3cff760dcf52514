// The volume kernels' band pointers and halo (fused3d.cu: B14, B15;
// streamed3d.cu: B16, B17, on the column walk of volwalk.cuh).
//
// A window is ty x tx core samples of a plane with a halo of HALO3 = 4 on
// y and x, at even starts, so local parity is global parity; z's halo is
// the walk's two warm-up pairs a side.  Window samples are read at
// whole-point mirrored positions: for even dims these equal the
// reference's mirror fills forward (fused3d.py:15-18) and its channel rules
// inverse (fused3d.py:19-22, streamed3d.py:314-330).
#pragma once

#include "tiles.cuh"

namespace tiles {

constexpr int HALO3 = 4;

// The 8 bands in (z, y, x) name order: band (bz << 2) | (by << 1) | bx.
template <typename T>
struct Bands8 {
    T* b[8];
};

}  // namespace tiles
