// Host build of the port's CUDA device code (zerochain_tpu_torch/csrc): the
// headers and the per-thread steps of totals_kernel.cu and
// column_scan_kernel.cu compile as plain C++,
// so their arithmetic can be held against the plain PyTorch versions where
// there is no CUDA toolkit.  Driven by tests/test_torch_csrc_host.py.
//
// stdin, one record after the other:
//   fq|fr|fs  a b            -> mont_mul, add, sub                 (hex words)
//   g1|g2     p q            -> add, double(p), madd, add in place (hex words)
//   k3 g2 N M T  planes digits order -> the window totals, one line a plane
//   cs g2 M T  planes               -> the column scan in place, one line a plane
// A block of T threads is stepped through in order, a barrier being the
// end of a loop over the threads.
#include <cstdio>
#include <cstring>
#include <vector>

#include "column_scan_kernel.cu"
#include "totals_kernel.cu"

template <int N> static void rd(uint32_t* a) { for (int i = 0; i < N; i++) if (scanf("%x", &a[i]) != 1) a[i] = 0; }
template <int N> static void pr(const uint32_t* a) { for (int i = 0; i < N; i++) printf("%08x ", a[i]); printf("\n"); }

template <class F> static void field_ops() {
  uint32_t a[F::N], b[F::N], r[F::N];
  rd<F::N>(a); rd<F::N>(b);
  fp_mont_mul<F>(r, a, b); pr<F::N>(r);
  fp_add<F>(r, a, b); pr<F::N>(r);
  fp_sub<F>(r, a, b); pr<F::N>(r);
}

template <class E> static void point_ops() {
  constexpr int PW = 3 * E::W;
  uint32_t p[PW], q[PW], r[PW];
  rd<PW>(p); rd<PW>(q);
  jac_add<E>(r, p, q); pr<PW>(r);
  jac_double<E>(r, p); pr<PW>(r);
  jac_madd<E>(r, p, q); pr<PW>(r);
  jac_add<E>(p, p, q); pr<PW>(p);
}

template <class E> static void totals(int N, long long M, int T) {
  constexpr int NP = 3 * E::W / 12, PW = 3 * E::W;
  std::vector<std::vector<uint32_t>> planes(NP, std::vector<uint32_t>(12 * N)),
      outs(NP, std::vector<uint32_t>(12 * M));
  std::vector<int32_t> dg(M * N), od(M * N);
  for (auto& p : planes) for (auto& x : p) if (scanf("%x", &x) != 1) x = 0;
  for (auto& x : dg) if (scanf("%d", &x) != 1) x = 0;
  for (auto& x : od) if (scanf("%d", &x) != 1) x = 0;
  TotalsArgs a;
  for (int k = 0; k < NP; k++) { a.planes[k] = planes[k].data(); a.out[k] = outs[k].data(); }
  a.digits = dg.data(); a.order = od.data(); a.N = N; a.M = M;
  for (long long m = 0; m < M; m++) {
    std::vector<uint32_t> run(T * PW), local(T * PW), sh(T * PW), other(T * PW);
    std::vector<int> mrun(T);
    for (int t = 0; t < T; t++) {
      totals_scan_run<E>(a, m, t, T, &run[t * PW], &local[t * PW], &mrun[t]);
      sh_store<E>(sh.data(), T, t, &run[t * PW]);
    }
    for (int s = 1; s < T; s <<= 1) {
      for (int t = s; t < T; t++) sh_load<E>(&other[t * PW], sh.data(), T, t - s);
      for (int t = s; t < T; t++) {
        jac_add<E>(&run[t * PW], &other[t * PW], &run[t * PW]);
        sh_store<E>(sh.data(), T, t, &run[t * PW]);
      }
    }
    for (int t = 0; t < T; t++) {
      if (t > 0) sh_load<E>(&other[t * PW], sh.data(), T, t - 1);
      else jac_set_identity<E>(&other[t * PW]);
    }
    for (int t = 0; t < T; t++) {
      totals_contribution<E>(&run[t * PW], &local[t * PW], &other[t * PW], mrun[t]);
      sh_store<E>(sh.data(), T, t, &run[t * PW]);
    }
    for (int s = T >> 1; s > 0; s >>= 1)
      for (int t = 0; t < s; t++) {
        sh_load<E>(&other[t * PW], sh.data(), T, t + s);
        jac_add<E>(&run[t * PW], &run[t * PW], &other[t * PW]);
        sh_store<E>(sh.data(), T, t, &run[t * PW]);
      }
    totals_write<E>(a, m, &run[0]);
  }
  for (auto& o : outs) { for (auto x : o) printf("%08x ", x); printf("\n"); }
}

template <class E> static void column_scan(long long M, int T) {
  constexpr int NP = 3 * E::W / 12;
  const long long n = M * T * ZC_CS_LANES;
  std::vector<std::vector<uint32_t>> planes(NP, std::vector<uint32_t>(12 * n));
  for (auto& p : planes) for (auto& x : p) if (scanf("%x", &x) != 1) x = 0;
  uint32_t* ptrs[NP];
  for (int k = 0; k < NP; k++) ptrs[k] = planes[k].data();
  for (long long m = 0; m < M; m++)
    for (int vl = 0; vl < ZC_CS_LANES; vl++) column_scan_lane<E>(ptrs, n, T, m, vl);
  for (auto& p : planes) { for (auto x : p) printf("%08x ", x); printf("\n"); }
}

int main() {
  char op[16];
  while (scanf("%15s", op) == 1) {
    if (!strcmp(op, "fq")) field_ops<FqP>();
    else if (!strcmp(op, "fr")) field_ops<FrP>();
    else if (!strcmp(op, "fs")) field_ops<FsP>();
    else if (!strcmp(op, "g1")) point_ops<FqE>();
    else if (!strcmp(op, "g2")) point_ops<Fq2E>();
    else if (!strcmp(op, "k3")) {
      int g2, N, T; long long M;
      if (scanf("%d %d %lld %d", &g2, &N, &M, &T) != 4) return 2;
      if (g2) totals<Fq2E>(N, M, T); else totals<FqE>(N, M, T);
    } else if (!strcmp(op, "cs")) {
      int g2, T; long long M;
      if (scanf("%d %lld %d", &g2, &M, &T) != 3) return 2;
      if (g2) column_scan<Fq2E>(M, T); else column_scan<FqE>(M, T);
    } else return 2;
  }
  return 0;
}
