// The fallback colours' draw from torch's CPU generator, exactly.
//
// torch.randint(256, shape, generator=g) on the CPU takes one 32-bit output
// of g's Mersenne Twister (at::mt19937) a element, in order, and keeps its
// low byte (V % 256). mt_draw_u8 does the same on the state bytes that
// g.get_state() returns and writes the advanced engine back into them, so
// that g.set_state() of the result leaves g where torch.randint would.
//
// The state layout is torch's CPUGeneratorImplState
// (aten/src/ATen/CPUGeneratorImpl.cpp): the legacy POD with the 624 state
// words widened to 64 bits, then the cached float normal sample. Only
// left, next and the words change; every other field is kept as it was.
#include <cstddef>
#include <cstdint>

namespace {

constexpr int N = 624;  // MERSENNE_STATE_N
constexpr int M = 397;  // MERSENNE_STATE_M
constexpr uint32_t MATRIX_A = 0x9908b0dfu;
constexpr uint32_t UMASK = 0x80000000u;
constexpr uint32_t LMASK = 0x7fffffffu;

struct LegacyState {  // CPUGeneratorImplStateLegacy
  uint64_t the_initial_seed;
  int left;
  int seeded;
  uint64_t next;
  uint64_t state[N];
  double normal_x;
  double normal_y;
  double normal_rho;
  int normal_is_valid;
};

struct GeneratorState {  // CPUGeneratorImplState
  LegacyState legacy_pod;
  float next_float_normal_sample;
  bool is_next_float_normal_sample_valid;
};

inline uint32_t twist(uint32_t u, uint32_t v) {
  return (((u & UMASK) | (v & LMASK)) >> 1) ^ ((0u - (v & 1u)) & MATRIX_A);
}

// at::mt19937::next_state, with indices in place of its moving pointer so
// that the compiler vectorizes both loops (each reads words M or N - M
// ahead of or behind the one it writes)
inline __attribute__((always_inline)) void next_state(uint32_t* s) {
  for (int k = 0; k < N - M; ++k) s[k] = s[k + M] ^ twist(s[k], s[k + 1]);
  for (int k = N - M; k < N - 1; ++k)
    s[k] = s[k + M - N] ^ twist(s[k], s[k + 1]);
  s[N - 1] = s[M - 1] ^ twist(s[N - 1], s[0]);
}

}  // namespace

extern "C" {

// The size of the state bytes mt_draw_u8 reads.
int64_t mt_state_bytes() { return sizeof(GeneratorState); }

// Writes the low bytes of the next n outputs into out and advances the
// state bytes in place. Returns 0, or -1 (nothing written) where the bytes
// are not a state at::mt19937 accepts. Built twice, for AVX2 and for any
// x86-64, and chosen when the library loads (8-lane vectors).
#if defined(__x86_64__)
__attribute__((target_clones("avx2", "default")))
#endif
int mt_draw_u8(void* state_bytes, int64_t size, uint8_t* out, int64_t n) {
  if (size != static_cast<int64_t>(sizeof(GeneratorState))) return -1;
  LegacyState& pod = static_cast<GeneratorState*>(state_bytes)->legacy_pod;
  int left = pod.left;
  // at::mt19937::is_valid, and no read past the words before a twist
  if (!pod.seeded || left < 1 || left > N || pod.next > N ||
      pod.next + left > N + 1)
    return -1;
  uint32_t s[N];
  for (int i = 0; i < N; ++i) s[i] = static_cast<uint32_t>(pod.state[i]);
  uint32_t next = static_cast<uint32_t>(pod.next);
  // at::mt19937::operator() n times: each output decrements left, twists
  // when left reaches 0 (then left = N, next = 0) and reads s[next++]. So
  // left - 1 outputs follow without a twist; they run as one loop.
  for (int64_t i = 0; i < n;) {
    if (left == 1) {
      next_state(s);
      left = N + 1;
      next = 0;
    }
    const int64_t k = (n - i < left - 1) ? n - i : left - 1;
    const uint32_t* src = s + next;
    for (int64_t j = 0; j < k; ++j) {
      uint32_t y = src[j];
      y ^= (y >> 11);
      y ^= (y << 7) & 0x9d2c5680u;
      y ^= (y << 15) & 0xefc60000u;
      y ^= (y >> 18);
      out[i + j] = static_cast<uint8_t>(y);  // V % 256
    }
    i += k;
    next += static_cast<uint32_t>(k);
    left -= static_cast<int>(k);
  }
  pod.left = left;
  pod.next = next;
  for (int i = 0; i < N; ++i) pod.state[i] = s[i];
  return 0;
}

}  // extern "C"
