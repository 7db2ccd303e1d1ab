// K10, the 3D instances (the kernel and its notes: edge_implicit.cuh),
// compiled apart from the 2D ones so the two build in parallel.
#include "edge_implicit.cuh"

namespace su2k {

template int launch_dim<float, 3>(int, const ImpConsts&, const Grid<float>&,
                                  int, int, const void*, const void*,
                                  const void*, const void*, const void*,
                                  void*, void*, void*, void*);
template int launch_dim<double, 3>(int, const ImpConsts&,
                                   const Grid<double>&, int, int,
                                   const void*, const void*, const void*,
                                   const void*, const void*, void*, void*,
                                   void*, void*);

}  // namespace su2k
