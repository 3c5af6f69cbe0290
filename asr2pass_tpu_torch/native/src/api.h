// Trimmed copy of the JAX package's native/src/api.h: the functions of
// native.cc, ctc_beam.cc and e2e_vad.cc only.
/* C ABI for the asr2pass_tpu native host library.
 *
 * Native equivalents of the reference's CPU-bound host pieces:
 *  - LinearResample  (onnxruntime/src/resample.cpp role)
 *  - Aho-Corasick hotword bias automaton (bias-lm.cpp role: prefix tree +
 *    failure arcs carrying negative back-off scores, consulted per symbol)
 *  - Levenshtein alignment (utils/compute-wer.py Calculator + the
 *    TimestampSmooth edit-distance backbone, util.cpp:415-462)
 *  - the E2E VAD decision automaton (e2e_vad.cc)
 *  - the CTC prefix beam over pruned candidates (ctc_beam.cc)
 *
 * All functions are plain C so Python binds via ctypes (no pybind11).
 */
#ifndef ASR2PASS_NATIVE_API_H
#define ASR2PASS_NATIVE_API_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- resampler ---- */
/* Returns number of output samples written to out (caller allocates
 * ceil(n_in * fs_out / fs_in) + 16). */
int64_t a2p_resample(const float* in, int64_t n_in, int fs_in, int fs_out,
                     int num_zeros, float* out);

/* ---- Aho-Corasick bias automaton over int32 symbol ids ---- */
typedef struct A2pAcBias A2pAcBias;

/* words: concatenated symbol ids; word_lens[n_words]; scores per word
 * (boost per symbol). */
A2pAcBias* a2p_ac_build(const int32_t* symbols, const int32_t* word_lens,
                        const float* per_symbol_scores, int32_t n_words);
void a2p_ac_free(A2pAcBias* ac);
/* Step: state in/out, returns score delta (negative on retraction). */
float a2p_ac_step(const A2pAcBias* ac, int32_t* state, int32_t symbol);
/* Final retraction for a dangling partial match. */
float a2p_ac_final(const A2pAcBias* ac, int32_t state);

/* ---- E2E VAD decision automaton (e2e-vad.h role) ----
 * Per-stream utterance state machine; the engine steps one per stream per
 * tick. Python (vad/e2e_vad.py) keeps decibel extraction and online
 * segment emission; this owns the per-frame loop (frame state + EMA +
 * window hysteresis + utterance machine + segment buffer). */
typedef struct A2pVad A2pVad;

A2pVad* a2p_vad_new(int detect_mode, int max_end_silence_time,
                    int max_start_silence_time, int window_size_ms,
                    int sil_to_speech_time_thres,
                    int speech_to_sil_time_thres, double speech_2_noise_ratio,
                    int do_extend, int lookback_time_start_point,
                    int lookahead_time_end_point, int max_single_segment_time,
                    double snr_thres, int noise_frame_num_used_for_snr,
                    double decibel_thres, double speech_noise_thres,
                    int frame_in_ms);
void a2p_vad_free(A2pVad* v);
void a2p_vad_reset(A2pVad* v);
/* Negative int / NaN double = keep current value. */
void a2p_vad_overrides(A2pVad* v, int max_end_sil_ms, int max_single_seg_ms,
                       double speech_noise_thres);
/* One chunk: sil_prob[t] = summed silence-pdf posterior (fp32),
 * decibel[t] = per-frame decibel (caller clamps history edges). */
void a2p_vad_chunk(A2pVad* v, const float* sil_prob, const double* decibel,
                   int32_t t, int32_t is_final);
int32_t a2p_vad_seg_count(const A2pVad* v);
/* out4 = {start_ms, end_ms, contain_start, contain_end} */
void a2p_vad_seg(const A2pVad* v, int32_t i, int32_t* out4);

/* ---- CTC prefix beam over pruned candidates (ctc_beam.cc) ----
 * cand_ids/cand_logp [T, K]; an optional context trie of n_nodes rows
 * (row 0 the root, parents before children). Writes up to `beam` n-best
 * rows of max_len ids/times; returns their count, or -1 on bad input. */
int32_t a2p_ctcbeam_decode(
    const int32_t* cand_ids, const float* cand_logp, int32_t T, int32_t K,
    int32_t beam, int32_t blank_id, int32_t n_nodes,
    const int32_t* node_parent, const int32_t* node_unit,
    const float* node_score, const uint8_t* node_is_end, int32_t* out_ids,
    int32_t* out_times, int32_t* out_lens, float* out_scores,
    int32_t max_len);

/* ---- Levenshtein alignment ---- */
/* a[n], b[m] are int32 symbol ids. ops_out must hold n+m entries.
 * Writes alignment ops: 0=match, 1=substitute, 2=delete(a only),
 * 3=insert(b only). Returns op count; distance written to *dist. */
int64_t a2p_edit_align(const int32_t* a, int64_t n, const int32_t* b,
                       int64_t m, int32_t* ops_out, int32_t* dist);

#ifdef __cplusplus
}
#endif
#endif
