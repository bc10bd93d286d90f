// Host kernel of the median engine medians="host": the two middle values of
// every bar's trade sizes by one nth_element a bar, the bars split over
// threads. A copy of seg_median_pair in finmlkit_tpu/native/seg_stats.cpp.
//
// Bars are contiguous trade ranges (ci[i], ci[i+1]], so each bar's values
// sit side by side in memory and a selection stays in cache.
//
// Build: g++ -O3 -std=c++17 -pthread -fPIC -shared (finmlkit_tpu_torch/native).
#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// The two middle values of each bar's values (np.median is their mean, taken
// by the caller in float64). Empty bars give 0 in both, which callers mask.
void seg_median_pair(const float* vals, const int64_t* ci, int64_t n_bars,
                     float* med_a, float* med_b, int n_threads) {
    auto worker = [&](int64_t b0, int64_t b1) {
        std::vector<float> buf;
        for (int64_t i = b0; i < b1; ++i) {
            int64_t start = ci[i] + 1, end = ci[i + 1];  // inclusive end
            int64_t c = end - start + 1;
            if (c <= 0) { med_a[i] = 0.f; med_b[i] = 0.f; continue; }
            if (c == 1) { med_a[i] = vals[start]; med_b[i] = vals[start]; continue; }
            buf.assign(vals + start, vals + end + 1);
            int64_t k_hi = c / 2;              // upper middle
            std::nth_element(buf.begin(), buf.begin() + k_hi, buf.end());
            float hi = buf[k_hi];
            if (c % 2 == 1) { med_a[i] = hi; med_b[i] = hi; continue; }
            // even count: the lower middle is the largest of the left part
            float lo = *std::max_element(buf.begin(), buf.begin() + k_hi);
            med_a[i] = lo; med_b[i] = hi;
        }
    };
    if (n_threads <= 1 || n_bars < 256) { worker(0, n_bars); return; }
    std::vector<std::thread> ts;
    int64_t step = (n_bars + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t b0 = t * step, b1 = std::min(n_bars, b0 + step);
        if (b0 >= b1) break;
        ts.emplace_back(worker, b0, b1);
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
