// Sanitizer harness for the native host runtime (TSan/ASan targets in the
// Makefile).  The reference's concurrency model was a single mutex
// (reference src/main.cpp:58-60); this runtime has threaded parsers, a
// threaded banded-DP ladder, a threaded k-mer radix build, and a
// lock-free shm tally ring — so the concurrency is validated with
// sanitizers instead of prose.
//
// Includes the production TU directly so internal structs (RingX,
// shm_wait_ge) are exercised as-built.  The ring's ranks are driven as
// THREADS here: TSan cannot observe cross-process races, and the memory
// protocol (release-store of the slot seq / acquire-load in the waiter,
// drained-counter slot-reuse guard) is identical whether peers are
// threads over one malloc'd buffer or processes over one /dev/shm
// mapping.
//
// Build + run:  make -C gfalign_tpu/native sanitize

#include "gfalign_host.cpp"

#include <atomic>
#include <cassert>
#include <cstdio>
#include <random>

static int g_failures = 0;

#define CHECK(cond)                                                      \
  do {                                                                   \
    if (!(cond)) {                                                       \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__, \
              #cond);                                                    \
      g_failures++;                                                      \
    }                                                                    \
  } while (0)

static void test_threaded_gaf_parse() {
  char path[] = "/tmp/gfsan_gaf_XXXXXX";
  int fd = mkstemp(path);
  FILE* f = fdopen(fd, "w");
  // > 1 MB so gaf_open fans out across parser threads
  for (int i = 0; i < 30000; i++)
    fprintf(f,
            "q%06d\t1000\t%d\t900\t+\t>s%d<s%d\t2000\t10\t910\t870\t900\t"
            "60\tNM:i:30\tAS:f:812.2\tcg:Z:900M\n",
            i % 3777, i % 50, i % 97, (i + 1) % 97);
  fclose(f);
  GafData* h = gaf_open(path);
  CHECK(h != nullptr);
  if (h) {
    CHECK(gaf_count(h) == 30000);
    CHECK(gaf_step_count(h) == 60000);
    gaf_close(h);
  }
  unlink(path);
}

static void test_fastx_parse() {
  char path[] = "/tmp/gfsan_fq_XXXXXX";
  int fd = mkstemp(path);
  FILE* f = fdopen(fd, "w");
  for (int i = 0; i < 5000; i++)
    fprintf(f, "@r%d\nACGTACGTACGTACGT\n+\n~~~~~~~~~~~~~~~~\n", i);
  fclose(f);
  FqData* h = fq_open(path);
  CHECK(h != nullptr);
  if (h) {
    CHECK(fq_count(h) == 5000);
    fq_close(h);
  }
  unlink(path);
}

static void test_threaded_kmer_build() {
  std::mt19937 rng(7);
  const int64_t n_blocks = 64, blk = 4096;
  std::vector<int8_t> codes(n_blocks * blk);
  for (auto& c : codes) c = static_cast<int8_t>(rng() % 4);
  std::vector<int64_t> starts(n_blocks), lens(n_blocks, blk);
  for (int64_t b = 0; b < n_blocks; b++) starts[b] = b * blk;
  int64_t total = kmer_index_build(codes.data(), codes.size(), starts.data(),
                                   lens.data(), n_blocks, 13, 0, nullptr,
                                   nullptr, nullptr);
  CHECK(total == n_blocks * (blk - 13 + 1));
  std::vector<int32_t> kms(total), blks(total), offs(total);
  int64_t got = kmer_index_build(codes.data(), codes.size(), starts.data(),
                                 lens.data(), n_blocks, 13, 0, kms.data(),
                                 blks.data(), offs.data());
  CHECK(got == total);
  for (int64_t i = 1; i < total; i++) CHECK(kms[i - 1] <= kms[i]);
}

static void test_threaded_banded_pairs() {
  std::mt19937 rng(11);
  const int64_t n_reads = 8, n_paths = 8, lr = 600, lp = 800,
                n_pairs = 512;
  std::vector<int8_t> reads(n_reads * lr), paths(n_paths * lp);
  for (auto& c : reads) c = static_cast<int8_t>(rng() % 4);
  for (auto& c : paths) c = static_cast<int8_t>(rng() % 4);
  std::vector<int64_t> r_off(n_reads), r_len(n_reads, lr), p_off(n_paths),
      p_len(n_paths, lp);
  for (int64_t i = 0; i < n_reads; i++) r_off[i] = i * lr;
  for (int64_t i = 0; i < n_paths; i++) p_off[i] = i * lp;
  std::vector<int32_t> rid(n_pairs), pid(n_pairs), dl(n_pairs, 0);
  for (int64_t i = 0; i < n_pairs; i++) {
    rid[i] = static_cast<int32_t>(i % n_reads);
    pid[i] = static_cast<int32_t>(i % n_paths);
  }
  std::vector<int32_t> best(n_pairs), bi(n_pairs), bj(n_pairs);
  std::vector<uint8_t> edge(n_pairs);
  seq_banded_pairs(reads.data(), r_off.data(), r_len.data(), paths.data(),
                   p_off.data(), p_len.data(), rid.data(), pid.data(),
                   dl.data(), n_pairs, 64, 1, -1, -1, 4, -100, best.data(),
                   bi.data(), bj.data(), edge.data());
  // identical (read, path, delta) pairs must agree regardless of the
  // thread that scored them
  for (int64_t i = 64; i < n_pairs; i++) {
    CHECK(best[i] == best[i % 64]);
    CHECK(bi[i] == bi[i % 64]);
    CHECK(bj[i] == bj[i % 64]);
  }
}

static void test_banded_traceback() {
  // identical read/path: the banded optimum is the pure diagonal, so the
  // end-cell value is known and the walk is all matches — exercises the
  // vectorized fill + the walk under the sanitizers
  std::mt19937 rng(17);
  const int64_t L = 300;
  std::vector<int8_t> seq(L + 50);
  for (auto& c : seq) c = static_cast<int8_t>(rng() % 4);
  int32_t out5[5];
  std::vector<char> ops(2 * (L + 50));
  int64_t n = seq_banded_traceback(seq.data(), L + 50, seq.data(), L + 50,
                                   L, L, 0, 64, static_cast<int32_t>(L),
                                   1, -2, -3, 5, -1000, out5, ops.data(),
                                   static_cast<int64_t>(ops.size()));
  CHECK(n == L);
  CHECK(out5[0] == L && out5[1] == 0 && out5[2] == 0 && out5[3] == L &&
        out5[4] == 0);
  for (int64_t i = 0; i < n; i++) CHECK(ops[i] == '=');
}

static void test_threaded_frontier_eval() {
  std::mt19937 rng(13);
  const int64_t C = 64, n = 16, R = 32, m = 12;
  std::vector<int32_t> a_keys(C * n), b_keys(R * m);
  for (auto& k : a_keys)
    k = static_cast<int32_t>((rng() % 50) * 4 + (rng() % 2));
  for (auto& k : b_keys)
    k = static_cast<int32_t>((rng() % 50) * 4 + (rng() % 2));
  std::vector<int32_t> a_len(C, static_cast<int32_t>(n)),
      b_len(R, static_cast<int32_t>(m));
  std::vector<int64_t> out(C * 3);
  nw_evaluate_frontier(a_keys.data(), a_len.data(), C, n, b_keys.data(),
                       b_len.data(), R, m, 1, -1, -1, 1, out.data());
  std::vector<int64_t> out2(C * 3);
  nw_evaluate_frontier(a_keys.data(), a_len.data(), C, n, b_keys.data(),
                       b_len.data(), R, m, 1, -1, -1, 1, out2.data());
  CHECK(out == out2);  // thread partitioning must not change results
}

static void test_ring_protocol() {
  // N rank-threads run the blocking sum-mode exchange (publish, wait for
  // every peer's batch-k slot, drain) for many more batches than there
  // are ring slots, so the slot-reuse guard (wait_peers_drained) is
  // exercised under TSan.  Every rank's batch-k contribution is
  // deterministic, so the summed tallies are checkable.
  const int NP = 4;
  const int64_t WIDTH = 48, SLOTS = 3, ITERS = 500, NV = 3;
  const int64_t slot = 2 + WIDTH;
  std::vector<int64_t> arr(1 + NP + NP * SLOTS * slot, 0);
  std::atomic<int> fails{0};
  std::vector<std::thread> th;
  for (int p = 0; p < NP; p++) {
    th.emplace_back([&, p] {
      search_impl::RingX r;
      r.arr = arr.data();
      r.width = WIDTH;
      r.ring = SLOTS;
      r.pid = p;
      r.nproc = NP;
      std::vector<int64_t> vals(NV);
      for (int64_t k = 0; k < ITERS; k++) {
        for (int64_t i = 0; i < NV; i++) vals[i] = (p + 1) * 1000 + k * 7 + i;
        const int64_t kb = r.pub;
        r.publish(vals.data(), NV);
        int64_t sum[NV];
        for (int64_t i = 0; i < NV; i++) sum[i] = vals[i];
        for (int q = 0; q < NP; q++) {
          if (q == p) continue;
          int64_t* s = r.slot(q, kb);
          search_impl::shm_wait_ge(&s[0], kb + 1);
          for (int64_t i = 0; i < NV; i++) sum[i] += s[2 + i];
        }
        r.mark_drained();
        for (int64_t i = 0; i < NV; i++) {
          int64_t want = 0;
          for (int q = 0; q < NP; q++) want += (q + 1) * 1000 + k * 7 + i;
          if (sum[i] != want) fails++;
        }
      }
    });
  }
  for (auto& t : th) t.join();
  CHECK(fails.load() == 0);
}

int main() {
  test_threaded_gaf_parse();
  test_fastx_parse();
  test_threaded_kmer_build();
  test_threaded_banded_pairs();
  test_banded_traceback();
  test_threaded_frontier_eval();
  test_ring_protocol();
  if (g_failures) {
    fprintf(stderr, "sanitize_test: %d FAILURES\n", g_failures);
    return 1;
  }
  printf("sanitize_test: all checks passed\n");
  return 0;
}
