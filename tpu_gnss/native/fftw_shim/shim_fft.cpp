// Mixed-radix complex FFT behind the fftw3f shim API (fftw3.h here).
//
// Recursive Cooley-Tukey over the small primes of the transform length
// (the reference's FFT_LEN=40000 = 2^6 * 5^4 factors into 2s and 5s; a
// generic prime butterfly covers anything else at O(n*p) per stage).
// Double-precision accumulation, float32 at the API boundary — at least
// as accurate as single-precision fftwf for the parity comparison.
//
// This is deliberately a correctness tool (builds the reference gps_test
// for golden diffing), not a performance path: the JAX framework's
// transforms run on device via XLA.

#include "fftw3.h"

#include <cmath>
#include <complex>
#include <cstdlib>
#include <vector>

namespace {

using cd = std::complex<double>;

struct Plan {
  int n;
  int sign;                 // -1 forward, +1 backward (unnormalized)
  fftwf_complex *in;
  fftwf_complex *out;
  std::vector<cd> twiddle;  // w^k = exp(sign * 2*pi*i * k / n), k < n
  std::vector<cd> buf_in, buf_out;
};

// Recursive decimation-in-time: split n = p * m on the smallest prime p,
// sub-transform the p interleaved sequences, then combine with twiddles.
//   X[q + m*r] = sum_i w_n^{i*(q + m*r)} * Y_i[q]
// Twiddle lookup uses modular index STEPPING ((kbase*i) % N accumulated
// incrementally) instead of a long multiply+modulo per term — the same
// twiddle values in the same summation order, so results stay
// bit-identical to the straightforward form while the hot combine loop
// runs several times faster.
void fft_rec(cd *out, const cd *in, int n, int in_stride,
             const std::vector<cd> &tw, long tw_stride) {
  if (n == 1) {
    out[0] = in[0];
    return;
  }
  int p = 2;
  while (n % p) ++p;        // smallest prime factor
  const int m = n / p;
  for (int i = 0; i < p; ++i)
    fft_rec(out + i * m, in + i * in_stride, m, in_stride * p,
            tw, tw_stride * p);
  const long N = (long)tw.size();
  std::vector<cd> tmp(p);
  for (int q = 0; q < m; ++q) {
    for (int i = 0; i < p; ++i) tmp[i] = out[q + i * m];
    for (int r = 0; r < p; ++r) {
      // w_n^{i*(q + m*r)} indexed in the level-local twiddle stride
      const long kbase = ((long)(q + (long)m * r) * tw_stride) % N;
      cd acc(0.0, 0.0);
      long idx = 0;
      for (int i = 0; i < p; ++i) {
        acc += tw[idx] * tmp[i];
        idx += kbase;
        if (idx >= N) idx -= N;   // kbase < N: one subtraction reduces
      }
      out[q + m * r] = acc;
    }
  }
}

}  // namespace

extern "C" {

fftwf_plan fftwf_plan_dft_1d(int n, fftwf_complex *in, fftwf_complex *out,
                             int sign, unsigned /*flags*/) {
  Plan *p = new Plan;
  p->n = n;
  p->sign = sign;
  p->in = in;
  p->out = out;
  p->twiddle.resize(n);
  const double s = (sign == FFTW_FORWARD) ? -1.0 : 1.0;
  for (int k = 0; k < n; ++k) {
    const double a = s * 2.0 * M_PI * (double)k / (double)n;
    p->twiddle[k] = cd(std::cos(a), std::sin(a));
  }
  p->buf_in.resize(n);
  p->buf_out.resize(n);
  return reinterpret_cast<fftwf_plan>(p);
}

void fftwf_execute(fftwf_plan plan) {
  Plan *p = reinterpret_cast<Plan *>(plan);
  for (int i = 0; i < p->n; ++i)
    p->buf_in[i] = cd((double)p->in[i][0], (double)p->in[i][1]);
  fft_rec(p->buf_out.data(), p->buf_in.data(), p->n, 1, p->twiddle, 1);
  for (int i = 0; i < p->n; ++i) {
    p->out[i][0] = (float)p->buf_out[i].real();
    p->out[i][1] = (float)p->buf_out[i].imag();
  }
}

void fftwf_destroy_plan(fftwf_plan plan) {
  delete reinterpret_cast<Plan *>(plan);
}

void *fftwf_malloc(unsigned long n) { return std::malloc(n); }
void fftwf_free(void *p) { std::free(p); }

}  // extern "C"
