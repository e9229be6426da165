// Marker-based watershed (priority-flood) — native host kernel.
//
// The deep-watershed postprocess of the Mesmer segmentation model (and the
// classical fiber pipeline) needs a sequential priority-flood that does not
// map to XLA; the reference delegated it to skimage's C implementation inside
// the remote DeepCell service. This is a fresh C++ implementation exposed via
// a C ABI for ctypes.
//
// watershed(image, markers, mask, H, W, out):
//   floods ascending `image` values from the labeled `markers`, restricted to
//   `mask` (mask==0 pixels stay 0). 4-connected.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Quantized bucket queue: priorities are mapped to kBuckets levels over the
// image's [min, max] range. Push/pop are O(1) (vs O(log n) for a binary
// heap — the flood visits every pixel once, so the queue is the whole cost).
// Within a bucket, pixels drain FIFO, which preserves the stable flooding
// order the old heap implementation used as its tiebreak; across buckets the
// cursor may step backwards when a neighbor's value is below the current
// level, matching exact min-first ordering up to quantization.
constexpr int kBuckets = 1 << 16;

}  // namespace

extern "C" {

void watershed(const float* image, const int32_t* markers,
               const uint8_t* mask, int32_t H, int32_t W, int32_t* out) {
    const int64_t n = static_cast<int64_t>(H) * W;
    std::vector<uint8_t> visited(n, 0);

    // robust quantization range: a single hot pixel (common in raw MIBI
    // channels) would otherwise stretch [vmin, vmax] so far that all the
    // meaningful relief collapses into one bucket and the flood
    // degenerates to marker-BFS. Clamp to the 0.1%/99.9% order statistics
    // of the masked values; outliers saturate into the end buckets, which
    // preserves the ordering of the main relief exactly.
    std::vector<float> vals;
    vals.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i]) vals.push_back(image[i]);
    }
    float vmin = 0.0f, vmax = 0.0f;
    if (!vals.empty()) {
        const size_t lo_k = vals.size() / 1000;
        const size_t hi_k = vals.size() - 1 - lo_k;
        std::nth_element(vals.begin(), vals.begin() + lo_k, vals.end());
        vmin = vals[lo_k];
        std::nth_element(vals.begin() + lo_k, vals.begin() + hi_k,
                         vals.end());
        vmax = vals[hi_k];
    }
    const float range = vmax - vmin;
    const float scale = range > 0.0f ? (kBuckets - 1) / range : 0.0f;

    std::vector<std::vector<int32_t>> buckets(kBuckets);
    std::vector<size_t> heads(kBuckets, 0);   // FIFO drain index per bucket
    int32_t cursor = kBuckets;

    auto push = [&](int64_t i) {
        int32_t b = static_cast<int32_t>((image[i] - vmin) * scale);
        if (b < 0) b = 0;
        if (b >= kBuckets) b = kBuckets - 1;
        buckets[b].push_back(static_cast<int32_t>(i));
        if (b < cursor) cursor = b;
    };

    for (int64_t i = 0; i < n; ++i) {
        out[i] = 0;
        if (markers[i] > 0 && mask[i]) {
            out[i] = markers[i];
            visited[i] = 1;
            push(i);
        }
    }

    const int32_t drow[4] = {-1, 1, 0, 0};
    const int32_t dcol[4] = {0, 0, -1, 1};

    while (cursor < kBuckets) {
        if (heads[cursor] >= buckets[cursor].size()) {
            buckets[cursor].clear();
            heads[cursor] = 0;
            ++cursor;
            continue;
        }
        const int32_t idx = buckets[cursor][heads[cursor]++];
        const int32_t r = idx / W;
        const int32_t c = idx % W;
        const int32_t label = out[idx];
        for (int k = 0; k < 4; ++k) {
            const int32_t rr = r + drow[k];
            const int32_t cc = c + dcol[k];
            if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
            const int64_t j = static_cast<int64_t>(rr) * W + cc;
            if (visited[j] || !mask[j]) continue;
            visited[j] = 1;
            out[j] = label;
            push(j);   // may move the cursor backwards: exact min-first
        }
    }
}

// Connected-component labeling (4-connected) for completeness; scipy is the
// usual host path, this exists for zero-scipy callers and as a native fallback.
void label_components(const uint8_t* mask, int32_t H, int32_t W,
                      int32_t* out, int32_t* n_labels) {
    const int64_t n = static_cast<int64_t>(H) * W;
    for (int64_t i = 0; i < n; ++i) out[i] = 0;
    int32_t next = 0;
    std::vector<int32_t> stack;
    const int32_t drow[4] = {-1, 1, 0, 0};
    const int32_t dcol[4] = {0, 0, -1, 1};
    for (int64_t i = 0; i < n; ++i) {
        if (!mask[i] || out[i]) continue;
        ++next;
        out[i] = next;
        stack.push_back(static_cast<int32_t>(i));
        while (!stack.empty()) {
            const int32_t cur = stack.back();
            stack.pop_back();
            const int32_t r = cur / W, c = cur % W;
            for (int k = 0; k < 4; ++k) {
                const int32_t rr = r + drow[k], cc = c + dcol[k];
                if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
                const int64_t j = static_cast<int64_t>(rr) * W + cc;
                if (mask[j] && !out[j]) {
                    out[j] = next;
                    stack.push_back(static_cast<int32_t>(j));
                }
            }
        }
    }
    *n_labels = next;
}

}  // extern "C"
