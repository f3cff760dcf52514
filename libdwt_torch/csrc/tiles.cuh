// The halos of the two-level window bodies (fused2l.cuh: B2/B5, and B8/B10
// and B11/B12's strips in streamed.cu) and of the volume kernels
// (tiles3.cuh).  Windows start at even global rows and columns, so window
// parity is global parity.
#pragma once

namespace tiles {

constexpr int HALO2 = 12;  // two levels forward: halo on both axes (signal samples)
constexpr int IH2 = 8;     // two levels inverse: level-2 halo (LL1 samples)
constexpr int IH1 = 4;     // two levels inverse: level-1 halo (signal samples)

}  // namespace tiles
