// Ragged-batch planning for transducer training input pipelines.
//
// Host-side runtime component (the reference ships none — its users hand-
// batch).  Groups utterances into batches under a frame budget using a
// sorted first-fit policy that (a) minimizes padding waste by batching
// similar-length utterances, and (b) quantizes padded lengths to a bucket
// grid so XLA sees a small set of static shapes (compile-cache friendly
// dynamic batching).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Inputs: frame lengths [N], symbol lengths [N], frame budget per batch,
// max utterances per batch, length quantum (padded lengths are rounded up
// to a multiple of this).
// Outputs (caller-allocated):
//   order   [N]   utterance indices, batch by batch
//   starts  [N+1] batch start offsets into `order` (only n_batches+1 used)
//   pad_t   [N]   per-batch padded frame length   (only n_batches used)
//   pad_s   [N]   per-batch padded symbol length  (only n_batches used)
// Returns the number of batches.
int32_t frt_plan_batches(const int32_t* frame_lens, const int32_t* sym_lens,
                         int32_t n, int32_t max_frames, int32_t max_batch,
                         int32_t quantum, int32_t* order, int32_t* starts,
                         int32_t* pad_t, int32_t* pad_s) {
  std::vector<int32_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
    if (frame_lens[a] != frame_lens[b]) return frame_lens[a] > frame_lens[b];
    return a < b;
  });

  auto quantize = [quantum](int32_t v) {
    return ((v + quantum - 1) / quantum) * quantum;
  };

  int32_t n_batches = 0, pos = 0;
  int32_t i = 0;
  starts[0] = 0;
  while (i < n) {
    // Longest remaining utterance defines the batch's padded frame length.
    const int32_t t_pad = quantize(frame_lens[idx[i]]);
    int32_t count = 0, s_max = 0;
    while (i < n && count < max_batch &&
           (int64_t)(count + 1) * t_pad <= max_frames) {
      s_max = std::max(s_max, sym_lens[idx[i]]);
      order[pos++] = idx[i++];
      ++count;
    }
    if (count == 0) {  // single utterance exceeding the budget: emit alone
      s_max = sym_lens[idx[i]];
      order[pos++] = idx[i++];
      count = 1;
    }
    pad_t[n_batches] = t_pad;
    pad_s[n_batches] = quantize(std::max(s_max, 1));
    starts[++n_batches] = pos;
  }
  return n_batches;
}

}  // extern "C"
