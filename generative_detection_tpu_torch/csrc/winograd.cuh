// The 1-D F(2,3) and F(4,3) row-Winograd transforms (Lavin & Gray points
// {0, +-1, +-2, inf}) as compile-time values, shared by the row-Winograd
// forward (conv3x3_wino.cu; in fp32 conv3x3.cu) and weight-gradient
// (conv3x3_wgrad.cu) kernels:
// loops over points that read them through a constexpr drop zero
// coefficients and multiplies by one.

#pragma once

// BT[a, u]: V_a = sum_u BT[a, u] z[M t + u - 1]
__host__ __device__ constexpr float bt_c(int m, int a, int u) {
  constexpr float t2[4][4] = {{1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
  constexpr float t4[6][6] = {{4, 0, -5, 0, 1, 0},  {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
                              {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
  return m == 2 ? t2[a][u] : t4[a][u];
}

// AT[i, a]: out[M t + i] = sum_a AT[i, a] G_a
__host__ __device__ constexpr float at_c(int m, int i, int a) {
  constexpr float t2[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
  constexpr float t4[4][6] = {
      {1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0}, {0, 1, -1, 8, -8, 1}};
  return m == 2 ? t2[i][a] : t4[i][a];
}
