// Copy of the JAX package's native/src/api.h; unchanged below this line.
/* C ABI for the asr2pass_tpu native host library.
 *
 * Native equivalents of the reference's CPU-bound host pieces:
 *  - LinearResample  (onnxruntime/src/resample.cpp role)
 *  - Aho-Corasick hotword bias automaton (bias-lm.cpp role: prefix tree +
 *    failure arcs carrying negative back-off scores, consulted per symbol)
 *  - Levenshtein alignment (utils/compute-wer.py Calculator + the
 *    TimestampSmooth edit-distance backbone, util.cpp:415-462)
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

/* ---- LM beam decoder (L-trie x backoff n-gram token passing) ----
 * Native port of decode/lm_decoder.py (the reference runs this search in
 * a patched Kaldi LatticeFasterOnlineDecoder, wfst-decoder.cpp). Unit ids
 * index the AM vocab; word ids index the LM vocab. */
typedef struct A2pLmDec A2pLmDec;

/* lexicon: n_lex entries of unit-id sequences (concatenated in lex_units,
 * lengths in lex_lens) mapping to lex_word_ids[i].
 * ngrams: n_ng entries of word-id sequences (concat ng_words, lengths
 * ng_lens) with log10 prob ng_logp[i] and log10 backoff ng_bow[i].
 * unk_id/bos_id are LM word ids. */
A2pLmDec* a2p_lmdec_create(
    int32_t order, const int32_t* lex_units, const int32_t* lex_lens,
    const int32_t* lex_word_ids, int32_t n_lex, const int32_t* ng_words,
    const int32_t* ng_lens, const float* ng_logp, const float* ng_bow,
    int64_t n_ng, int32_t unk_id, int32_t bos_id, float lm_weight,
    float oov_penalty, int32_t beam, int32_t am_topk);
void a2p_lmdec_free(A2pLmDec* d);

/* Per-connection decoder sharing src's (read-only) lexicon/LM tables:
 * O(1), empty bias — attach hotwords with a2p_lmdec_set_bias. Clones
 * may decode concurrently with src and each other. */
A2pLmDec* a2p_lmdec_clone(const A2pLmDec* src);

/* Optional hotword bias (ContextGraph role): per-phrase unit-id
 * sequences; sym_scores is aligned with units (per-symbol incremental
 * boost, already x char-count like context_graph.py build). */
void a2p_lmdec_set_bias(A2pLmDec* d, const int32_t* units,
                        const int32_t* lens, const float* sym_scores,
                        int32_t n_phrases);
void a2p_lmdec_clear_bias(A2pLmDec* d);

/* Decode rows[n*v] of log-posteriors; skip_ids are unit ids never taken
 * (<blank>/<s>/</s>/<unk>). Writes the best path: out_units[n] = unit
 * chosen per row; out_words[n] = LM word id completed at that row, -1 if
 * mid-word, -2 if an OOV word (its units) ended there. Returns number of
 * rows consumed (== n) or -1 on error. */
int64_t a2p_lmdec_decode(A2pLmDec* d, const float* rows, int64_t n,
                         int32_t v, const int32_t* skip_ids,
                         int32_t n_skip, int32_t* out_units,
                         int32_t* out_words);

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
