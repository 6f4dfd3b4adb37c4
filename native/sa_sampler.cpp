// qbmx native simulated-annealing sampler (host-side C++).
//
// First-party replacement for the role dwave-neal's C++ core plays in the
// reference (SURVEY.md §2a): Metropolis SA over a dense QUBO with
// num_reads restarts × num_sweeps sweeps on a geometric beta ramp.  Used as
// the CPU fallback / cross-check backend ("SA-NATIVE" solver); the GPU path
// is the Pallas kernel in qbmx/samplers/anneal_kernel.py.
//
// Implementation notes:
//   * Incremental local fields: field[j] = h[j] + Σ_i J[ij] s_i maintained
//     per chain, O(1) flip evaluation + O(n) update on accept (the classic
//     efficient single-spin scheme; the reference's sampler does the same
//     inside dwave-neal).
//   * Chains fan out over std::thread workers — the native analogue of the
//     reference's 10-process pool (src/model/faster_dqbm.py:98-111), except
//     every chain gets an independent splitmix64-seeded xoshiro256** stream
//     (the reference reused one seed across workers, SURVEY.md §2c.4).
//
// C ABI (ctypes-friendly), exported below:
//   qbmx_sa_sample_batch(Q, B, n, num_reads, num_sweeps, seed, out)
//     Q:   B × n × n row-major float32, upper-triangular + diagonal=linear
//     out: B × num_reads × n float32 in {0,1}
//   qbmx_sa_default_beta_range(Q, n, &hot, &cold)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 expansion
    for (int i = 0; i < 4; ++i) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// h (n) and symmetric J (n*n, zero diag) from a dense upper-tri QUBO.
void split_qubo(const float* Q, int n, std::vector<double>& h, std::vector<double>& J) {
  h.assign(n, 0.0);
  J.assign(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < n; ++i) {
    h[i] = Q[static_cast<size_t>(i) * n + i];
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      double c = Q[static_cast<size_t>(i) * n + j] + Q[static_cast<size_t>(j) * n + i];
      // each off-diagonal pair contributes once; both triangles folded
      if (i < j) {
        J[static_cast<size_t>(i) * n + j] = c;
        J[static_cast<size_t>(j) * n + i] = c;
      }
    }
  }
}

// neal-style default range: hot flips the stiffest variable with p~1/2,
// cold freezes the smallest individual energy scale (matches
// qbmx/core/qubo.py default_beta_range).
void default_beta_range(const std::vector<double>& h, const std::vector<double>& J, int n,
                        double* hot, double* cold) {
  double max_delta = 0.0;
  double min_mag = HUGE_VAL;
  for (int i = 0; i < n; ++i) {
    double tot = std::fabs(h[i]);
    if (std::fabs(h[i]) > 0) min_mag = std::min(min_mag, std::fabs(h[i]));
    for (int j = 0; j < n; ++j) {
      double a = std::fabs(J[static_cast<size_t>(i) * n + j]);
      tot += a;
      if (a > 0) min_mag = std::min(min_mag, a);
    }
    max_delta = std::max(max_delta, tot);
  }
  *hot = max_delta > 0 ? std::log(2.0) / max_delta : 0.1;
  *cold = std::isfinite(min_mag) ? std::log(100.0) / min_mag : 10.0;
  if (*cold <= *hot) *cold = *hot * 1.0001;
}

void anneal_chain(const std::vector<double>& h, const std::vector<double>& J, int n,
                  int num_sweeps, double beta_hot, double log_ratio, Xoshiro256& rng,
                  float* out_row) {
  std::vector<uint8_t> s(n);
  std::vector<double> field(h);  // field[j] = h[j] + Σ_i J[ij] s_i
  for (int i = 0; i < n; ++i) {
    s[i] = static_cast<uint8_t>(rng.next() & 1);
  }
  for (int j = 0; j < n; ++j) {
    double f = h[j];
    for (int i = 0; i < n; ++i)
      if (s[i]) f += J[static_cast<size_t>(i) * n + j];
    field[j] = f;
  }
  const double inv_span = num_sweeps > 1 ? 1.0 / (num_sweeps - 1) : 0.0;
  for (int t = 0; t < num_sweeps; ++t) {
    const double beta = beta_hot * std::exp(log_ratio * (t * inv_span));
    for (int i = 0; i < n; ++i) {
      const double delta = (s[i] ? -1.0 : 1.0) * field[i];
      bool accept = delta <= 0.0 || rng.uniform() < std::exp(-beta * delta);
      if (accept) {
        const double dir = s[i] ? -1.0 : 1.0;
        s[i] ^= 1;
        const double* Jrow = &J[static_cast<size_t>(i) * n];
        for (int j = 0; j < n; ++j) field[j] += dir * Jrow[j];
        field[i] -= dir * Jrow[i];  // J diag is zero anyway; keep exact
      }
    }
  }
  for (int i = 0; i < n; ++i) out_row[i] = static_cast<float>(s[i]);
}

}  // namespace

extern "C" {

void qbmx_sa_default_beta_range(const float* Q, int n, double* hot, double* cold) {
  std::vector<double> h, J;
  split_qubo(Q, n, h, J);
  default_beta_range(h, J, n, hot, cold);
}

// shared body: base_seeds[b] is each problem's chain-seed base (chain
// (b, r) runs Xoshiro256(base_seeds[b] ^ r) — the constructor's splitmix64
// scrambler decorrelates adjacent values, the same property the original
// single-seed form relied on)
static void sample_batch_impl(const float* Q, int B, int n, int num_reads,
                              int num_sweeps, const uint64_t* base_seeds,
                              float* out) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());

  // per-problem couplings and schedules, prepared once
  std::vector<std::vector<double>> hs(B), Js(B);
  std::vector<double> hots(B), log_ratios(B);
  for (int b = 0; b < B; ++b) {
    split_qubo(Q + static_cast<size_t>(b) * n * n, n, hs[b], Js[b]);
    double hot, cold;
    default_beta_range(hs[b], Js[b], n, &hot, &cold);
    if (num_sweeps == 1) hot = cold;  // match sa_jax/sa_pallas: one sweep runs cold
    hots[b] = hot;
    log_ratios[b] = std::log(cold / hot);
  }

  // one flat work queue over all B*num_reads chains: every core stays busy
  // and one thread pool serves the whole call
  const long total = static_cast<long>(B) * num_reads;
  std::atomic<long> next{0};
  auto worker = [&]() {
    for (;;) {
      long idx = next.fetch_add(1);
      if (idx >= total) break;
      const int b = static_cast<int>(idx / num_reads);
      const int r = static_cast<int>(idx % num_reads);
      Xoshiro256 rng(base_seeds[b] ^ static_cast<uint64_t>(r));
      anneal_chain(hs[b], Js[b], n, num_sweeps, hots[b], log_ratios[b], rng,
                   out + (static_cast<size_t>(b) * num_reads + r) * n);
    }
  };
  const unsigned n_threads = std::min<unsigned>(hw, static_cast<unsigned>(total));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (unsigned w = 0; w < n_threads; ++w) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void qbmx_sa_sample_batch(const float* Q, int B, int n, int num_reads, int num_sweeps,
                          uint64_t seed, float* out) {
  std::vector<uint64_t> base(B);
  for (int b = 0; b < B; ++b) base[b] = seed ^ (static_cast<uint64_t>(b) << 32);
  sample_batch_impl(Q, B, n, num_reads, num_sweeps, base.data(), out);
}

// per-problem seed variant: problem b's chains depend on seeds[b] alone, so
// a caller holding per-problem PRNG keys gets true per-problem stream
// reproducibility (exact here because chains never
// share draws across problems)
void qbmx_sa_sample_batch_seeds(const float* Q, int B, int n, int num_reads,
                                int num_sweeps, const uint64_t* seeds,
                                float* out) {
  sample_batch_impl(Q, B, n, num_reads, num_sweeps, seeds, out);
}

}  // extern "C"
