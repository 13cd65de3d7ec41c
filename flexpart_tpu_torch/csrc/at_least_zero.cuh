// max(v, 0) as jnp.maximum, a NaN passing through: the backward deposition
// factor of K3's, K9's and K10's BKDEP instantiations
// (physics/bkdep.py, grid/conccalc.py).
#pragma once

namespace fp {

__device__ __forceinline__ float at_least_zero(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

}  // namespace fp
