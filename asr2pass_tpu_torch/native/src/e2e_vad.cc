// Copy of the JAX package's native/src/e2e_vad.cc; unchanged below this line.
// E2E VAD decision automaton — native hot loop for the batched engine.
//
// Behavioral port of the reference's header-only decision logic
// (onnxruntime/src/e2e-vad.h:184-267 WindowDetector, :591-639 frame state
// with SNR gating + noise-decibel EMA, :670-781 DetectOneFrame utterance
// machine, :471-522 segment buffer pops). Decision-identical to the Python
// port in vad/e2e_vad.py (the parity oracle, tests/test_native.py): the
// engine advances one automaton per stream per tick, and the per-frame
// Python loop was the largest host cost of the batched tick (~177 ms of a
// ~280 ms tick at 64 streams — scripts/tick_breakdown.py), so the frame
// loop moves here. Python keeps: decibel extraction (vectorized numpy),
// segment emission (online [s,-1]/[-1,e] splitting), and per-call
// overrides.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// frame states
constexpr int kSil = 0;
constexpr int kSpeech = 1;
// machine states
constexpr int kStartNotDetected = 1;
constexpr int kInSpeech = 2;
constexpr int kEndDetected = 3;
// window change states
constexpr int kS2S = 0, kS2Sil = 1, kSil2Sil = 2, kSil2S = 3;

struct Seg {
  int32_t start_ms = 0;
  int32_t end_ms = 0;
  int32_t contain_start = 0;
  int32_t contain_end = 0;
};

struct Opts {
  int detect_mode = 1;
  int max_end_silence_time = 800;
  int max_start_silence_time = 3000;
  int window_size_ms = 200;
  int sil_to_speech_time_thres = 150;
  int speech_to_sil_time_thres = 150;
  double speech_2_noise_ratio = 1.0;
  int do_extend = 1;
  int lookback_time_start_point = 200;
  int lookahead_time_end_point = 100;
  int max_single_segment_time = 15000;
  double snr_thres = -100.0;
  int noise_frame_num_used_for_snr = 100;
  double decibel_thres = -100.0;
  double speech_noise_thres = 0.6;
  int frame_in_ms = 10;
};

struct WindowDetector {
  int win_size_frame = 20;
  int sil_to_speech_thres = 15;
  int speech_to_sil_thres = 15;
  int win_sum = 0;
  std::vector<int> win_state;
  int cur_win_pos = 0;
  int pre_frame_state = kSil;

  void init(const Opts& o) {
    win_size_frame = o.window_size_ms / o.frame_in_ms;
    sil_to_speech_thres = o.sil_to_speech_time_thres / o.frame_in_ms;
    speech_to_sil_thres = o.speech_to_sil_time_thres / o.frame_in_ms;
    reset();
  }
  void reset() {
    win_sum = 0;
    win_state.assign(win_size_frame, 0);
    cur_win_pos = 0;
    pre_frame_state = kSil;
  }
  int detect_one_frame(int frame_state) {
    int cur = frame_state == kSpeech ? 1 : 0;
    win_sum += cur - win_state[cur_win_pos];
    win_state[cur_win_pos] = cur;
    cur_win_pos = (cur_win_pos + 1) % win_size_frame;
    if (pre_frame_state == kSil && win_sum >= sil_to_speech_thres) {
      pre_frame_state = kSpeech;
      return kSil2S;
    }
    if (pre_frame_state == kSpeech && win_sum <= speech_to_sil_thres) {
      pre_frame_state = kSil;
      return kS2Sil;
    }
    return pre_frame_state == kSil ? kSil2Sil : kS2S;
  }
};

}  // namespace

struct A2pVad {
  Opts opts;
  WindowDetector win;

  int64_t frm_cnt = 0;
  int64_t data_buf_start_frame = 0;
  int64_t latest_confirmed_speech_frame = 0;
  int64_t latest_confirmed_silence_frame = -1;
  int64_t continous_silence_frame_count = 0;
  int machine_state = kStartNotDetected;
  int64_t confirmed_start_frame = -1;
  int64_t confirmed_end_frame = -1;
  int64_t number_end_time_detected = 0;
  double noise_average_decibel = -100.0;
  double speech_noise_thres = 0.6;
  int max_end_sil_frame_cnt_thresh = 650;
  std::vector<Seg> segs;

  void all_reset() {
    frm_cnt = 0;
    data_buf_start_frame = 0;
    number_end_time_detected = 0;
    noise_average_decibel = -100.0;
    segs.clear();
    speech_noise_thres = opts.speech_noise_thres;
    max_end_sil_frame_cnt_thresh =
        opts.max_end_silence_time - opts.speech_to_sil_time_thres;
    reset_detection();
  }
  void reset_detection() {
    continous_silence_frame_count = 0;
    latest_confirmed_speech_frame = 0;
    latest_confirmed_silence_frame = -1;
    confirmed_start_frame = -1;
    confirmed_end_frame = -1;
    machine_state = kStartNotDetected;
    win.reset();
  }

  int64_t latency_frames() const {
    int64_t latency = win.win_size_frame;
    if (opts.do_extend)
      latency += opts.lookback_time_start_point / opts.frame_in_ms;
    return latency;
  }

  // PopDataToOutputBuf role (e2e-vad.h:471-522)
  void pop_to_output(int64_t start_frm, int64_t frm_n, bool first_is_start,
                     bool last_is_end) {
    int ms = opts.frame_in_ms;
    if (segs.empty() || first_is_start) {
      Seg s;
      s.start_ms = static_cast<int32_t>(start_frm * ms);
      s.end_ms = static_cast<int32_t>(start_frm * ms);
      segs.push_back(s);
    }
    Seg& cur = segs.back();
    if (start_frm + frm_n > data_buf_start_frame)
      data_buf_start_frame = start_frm + frm_n;
    cur.end_ms = static_cast<int32_t>((start_frm + frm_n) * ms);
    if (first_is_start) cur.contain_start = 1;
    if (last_is_end) cur.contain_end = 1;
  }

  void on_silence_detected(int64_t t) {
    latest_confirmed_silence_frame = t;
    if (machine_state == kStartNotDetected && t > data_buf_start_frame)
      data_buf_start_frame = t;
  }
  void on_voice_detected(int64_t t) {
    latest_confirmed_speech_frame = t;
    pop_to_output(t, 1, false, false);
  }
  void on_voice_start(int64_t t, bool fake = false) {
    if (confirmed_start_frame == -1) confirmed_start_frame = t;
    if (!fake && machine_state == kStartNotDetected)
      pop_to_output(confirmed_start_frame, 1, true, false);
  }
  void on_voice_end(int64_t t, bool fake, bool /*is_last*/) {
    for (int64_t f = latest_confirmed_speech_frame + 1; f < t; ++f)
      on_voice_detected(f);
    if (confirmed_end_frame == -1) confirmed_end_frame = t;
    if (!fake) pop_to_output(confirmed_end_frame, 1, false, true);
    number_end_time_detected += 1;
  }
  void maybe_end_last_frame(bool is_final_frame, int64_t t) {
    if (is_final_frame) {
      on_voice_end(t, false, true);
      machine_state = kEndDetected;
    }
  }

  // DetectOneFrame (e2e-vad.h:670-781)
  void detect_one_frame(int frame_state, int64_t t, bool is_final_frame) {
    const Opts& o = opts;
    int change = win.detect_one_frame(frame_state);
    int ms = o.frame_in_ms;
    if (change == kSil2S) {
      continous_silence_frame_count = 0;
      if (machine_state == kStartNotDetected) {
        int64_t start = t - latency_frames();
        if (data_buf_start_frame > start) start = data_buf_start_frame;
        on_voice_start(start);
        machine_state = kInSpeech;
        for (int64_t f = start + 1; f <= t; ++f) on_voice_detected(f);
      } else if (machine_state == kInSpeech) {
        for (int64_t f = latest_confirmed_speech_frame + 1; f < t; ++f)
          on_voice_detected(f);
        if (t - confirmed_start_frame + 1 > o.max_single_segment_time / ms) {
          on_voice_end(t, false, false);
          machine_state = kEndDetected;
        } else if (!is_final_frame) {
          on_voice_detected(t);
        } else {
          maybe_end_last_frame(is_final_frame, t);
        }
      }
    } else if (change == kS2Sil) {
      continous_silence_frame_count = 0;
      if (machine_state == kInSpeech) {
        if (t - confirmed_start_frame + 1 > o.max_single_segment_time / ms) {
          on_voice_end(t, false, false);
          machine_state = kEndDetected;
        } else if (!is_final_frame) {
          on_voice_detected(t);
        } else {
          maybe_end_last_frame(is_final_frame, t);
        }
      }
    } else if (change == kS2S) {
      continous_silence_frame_count = 0;
      if (machine_state == kInSpeech) {
        if (t - confirmed_start_frame + 1 > o.max_single_segment_time / ms) {
          on_voice_end(t, false, false);
          machine_state = kEndDetected;
        } else if (!is_final_frame) {
          on_voice_detected(t);
        } else {
          maybe_end_last_frame(is_final_frame, t);
        }
      }
    } else {  // kSil2Sil
      continous_silence_frame_count += 1;
      if (machine_state == kStartNotDetected) {
        bool single_mode = o.detect_mode == 0;
        if ((single_mode && continous_silence_frame_count * ms >
                                o.max_start_silence_time) ||
            (is_final_frame && number_end_time_detected == 0)) {
          for (int64_t f = latest_confirmed_silence_frame + 1; f < t; ++f)
            on_silence_detected(f);
          on_voice_start(0, true);
          on_voice_end(0, true, false);
          machine_state = kEndDetected;
        } else {
          if (t >= latency_frames()) on_silence_detected(t - latency_frames());
        }
      } else if (machine_state == kInSpeech) {
        if (continous_silence_frame_count * ms >=
            max_end_sil_frame_cnt_thresh) {
          int64_t lookback = max_end_sil_frame_cnt_thresh / ms;
          if (o.do_extend) {
            lookback -= o.lookahead_time_end_point / ms;
            lookback -= 1;
            if (lookback < 0) lookback = 0;
          }
          on_voice_end(t - lookback, false, false);
          machine_state = kEndDetected;
        } else if (t - confirmed_start_frame + 1 >
                   o.max_single_segment_time / ms) {
          on_voice_end(t, false, false);
          machine_state = kEndDetected;
        } else if (o.do_extend && !is_final_frame) {
          if (continous_silence_frame_count <=
              o.lookahead_time_end_point / ms) {
            on_voice_detected(t);
          }
        } else {
          maybe_end_last_frame(is_final_frame, t);
        }
      }
    }
    if (machine_state == kEndDetected && o.detect_mode == 1)
      reset_detection();
  }

  // GetFrameState + chunk loop (e2e-vad.h:591-639). sil_prob: summed
  // silence-pdf posterior per frame (fp32, matching the numpy fp32 sum);
  // dec: per-frame decibel already clamped by the caller.
  void chunk(const float* sil_prob, const double* dec, int32_t t,
             int32_t is_final) {
    int64_t base = frm_cnt;
    frm_cnt += t;
    if (machine_state == kEndDetected) return;  // _detect_*_frames guard
    const Opts& o = opts;
    int n = o.noise_frame_num_used_for_snr;
    for (int32_t i = 0; i < t; ++i) {
      double d = dec[i];
      int state = kSil;
      if (d >= o.decibel_thres) {
        // same exp(log(max(.))) composition as the Python/numpy path
        double s = static_cast<double>(sil_prob[i]);
        double noise_p =
            std::exp(std::log(std::max(s, 1e-12)) * o.speech_2_noise_ratio);
        double speech_p = std::exp(std::log(std::max(1.0 - s, 1e-12)));
        if (speech_p >= noise_p + speech_noise_thres) {
          if (d - noise_average_decibel >= o.snr_thres) state = kSpeech;
        } else if (noise_average_decibel < -99.9) {
          noise_average_decibel = d;
        } else {
          noise_average_decibel =
              (d + noise_average_decibel * (n - 1)) / n;
        }
      }
      bool final_frame = is_final && i == t - 1;
      detect_one_frame(state, base + i, final_frame);
    }
  }
};

extern "C" {

A2pVad* a2p_vad_new(int detect_mode, int max_end_silence_time,
                    int max_start_silence_time, int window_size_ms,
                    int sil_to_speech_time_thres,
                    int speech_to_sil_time_thres, double speech_2_noise_ratio,
                    int do_extend, int lookback_time_start_point,
                    int lookahead_time_end_point, int max_single_segment_time,
                    double snr_thres, int noise_frame_num_used_for_snr,
                    double decibel_thres, double speech_noise_thres,
                    int frame_in_ms) {
  A2pVad* v = new A2pVad();
  Opts& o = v->opts;
  o.detect_mode = detect_mode;
  o.max_end_silence_time = max_end_silence_time;
  o.max_start_silence_time = max_start_silence_time;
  o.window_size_ms = window_size_ms;
  o.sil_to_speech_time_thres = sil_to_speech_time_thres;
  o.speech_to_sil_time_thres = speech_to_sil_time_thres;
  o.speech_2_noise_ratio = speech_2_noise_ratio;
  o.do_extend = do_extend;
  o.lookback_time_start_point = lookback_time_start_point;
  o.lookahead_time_end_point = lookahead_time_end_point;
  o.max_single_segment_time = max_single_segment_time;
  o.snr_thres = snr_thres;
  o.noise_frame_num_used_for_snr = noise_frame_num_used_for_snr;
  o.decibel_thres = decibel_thres;
  o.speech_noise_thres = speech_noise_thres;
  o.frame_in_ms = frame_in_ms;
  v->win.init(o);
  v->all_reset();
  return v;
}

void a2p_vad_free(A2pVad* v) { delete v; }

void a2p_vad_reset(A2pVad* v) { v->all_reset(); }

// Per-call overrides (engine per-connection options). Negative int /
// NaN double = keep current value. max_end_sil mirrors the Python
// setter: thresh = ms - speech_to_sil_time_thres.
void a2p_vad_overrides(A2pVad* v, int max_end_sil_ms, int max_single_seg_ms,
                       double speech_noise_thres) {
  if (max_end_sil_ms >= 0)
    v->max_end_sil_frame_cnt_thresh =
        max_end_sil_ms - v->opts.speech_to_sil_time_thres;
  if (max_single_seg_ms >= 0)
    v->opts.max_single_segment_time = max_single_seg_ms;
  if (!std::isnan(speech_noise_thres))
    v->speech_noise_thres = speech_noise_thres;
}

void a2p_vad_chunk(A2pVad* v, const float* sil_prob, const double* decibel,
                   int32_t t, int32_t is_final) {
  v->chunk(sil_prob, decibel, t, is_final);
}

int32_t a2p_vad_seg_count(const A2pVad* v) {
  return static_cast<int32_t>(v->segs.size());
}

// out4 = {start_ms, end_ms, contain_start, contain_end}
void a2p_vad_seg(const A2pVad* v, int32_t i, int32_t* out4) {
  const Seg& s = v->segs[i];
  out4[0] = s.start_ms;
  out4[1] = s.end_ms;
  out4[2] = s.contain_start;
  out4[3] = s.contain_end;
}

}  // extern "C"
