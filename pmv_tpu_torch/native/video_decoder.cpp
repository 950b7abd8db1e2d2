// Native video decode library of pmv_tpu_torch (a copy of pmv_tpu's).
//
// TPU-native replacement for the reference's PyAV/decord/torchvision decode
// backends (MViT/slowfast/datasets/video_container.py:10-36,
// decoder.py:416-489 pyav_decode): FFmpeg demux + PTS-selective seek +
// forward decode of only the clip window + swscale resize to the target
// geometry, RGB24 output into caller-owned host memory. Exposed as a C ABI
// for ctypes binding; thread-safe at one-decoder-per-thread granularity
// (the loader runs a decode thread pool; FFmpeg releases the GIL entirely
// since we never touch Python here).
//
// Build: pmv_tpu_torch/native/binding.py runs g++ on first use (links
// libavformat/libavcodec/libswscale/libswresample/libavutil).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_idx = -1;
  double fps = 0.0;      // avg rate (pyav `average_rate` parity, sampling math)
  double idx_fps = 0.0;  // base tick rate (pts -> frame-index mapping)
  int64_t nb_frames = 0;     // container-reported (may be 0/approximate)
  double duration_sec = 0.0;
  int width = 0;
  int height = 0;
  std::string error;
};

double stream_fps(AVStream* st) {
  AVRational r = st->avg_frame_rate;
  if (r.num == 0 || r.den == 0) r = st->r_frame_rate;
  if (r.num == 0 || r.den == 0) return 0.0;
  return av_q2d(r);
}

// Base (container) frame rate for pts -> frame-index mapping. avg_frame_rate
// = nb_frames / duration is what pyav reports (and what the sampling math
// uses, parity), but on mp4 the duration excludes the last frame's span, so
// avg is slightly high (e.g. 30.34 for 90 frames @ 30) and llround(pts *
// avg) misindexes late frames. r_frame_rate is the stream's real tick rate.
double index_fps(AVStream* st) {
  AVRational r = st->r_frame_rate;
  if (r.num == 0 || r.den == 0) r = st->avg_frame_rate;
  if (r.num == 0 || r.den == 0) return 0.0;
  return av_q2d(r);
}

// Horizontal lerp of one row as a FLAT gather loop: element j of the
// output row reads trow[off0[j]]/trow[off1[j]] with weight wx[j]
// (j = x*3 + ch, offsets precomputed once per image). Scalar reference;
// op order is a + (b-a)*f with one round-to-nearest-even at the end.
void hrow_scalar(const float* trow, uint8_t* drow, const int32_t* off0,
                 const int32_t* off1, const float* wx, int n) {
  for (int j = 0; j < n; ++j) {
    const float a = trow[off0[j]];
    const float b = trow[off1[j]];
    float v = a + (b - a) * wx[j];
    v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
    drow[j] = static_cast<uint8_t>(std::lrintf(v));
  }
}

// Vertical lerp of one output row: trow[k] = r0[k] + (r1[k] - r0[k]) * f
// over the full sw*3 span (contiguous, u8 in / f32 out).
void vrow_scalar(const uint8_t* r0, const uint8_t* r1, float* trow, float f,
                 int n) {
  for (int k = 0; k < n; ++k)
    trow[k] = r0[k] + (r1[k] - r0[k]) * f;
}

#if defined(__x86_64__) || defined(__i386__)
// AVX2 vertical row: 8 u8 -> f32 widens + the same mul/add order as the
// scalar loop (bit-identical f32 results).
__attribute__((target("avx2")))
void vrow_avx2(const uint8_t* r0, const uint8_t* r1, float* trow, float f,
               int n) {
  const __m256 vf = _mm256_set1_ps(f);
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    __m256 a = _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(r0 + k))));
    __m256 b = _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(r1 + k))));
    _mm256_storeu_ps(
        trow + k, _mm256_add_ps(a, _mm256_mul_ps(_mm256_sub_ps(b, a), vf)));
  }
  if (k < n) vrow_scalar(r0 + k, r1 + k, trow + k, f, n - k);
}

// AVX2 horizontal row: 8-wide f32 gathers + the same a + (b-a)*f order
// (mul then add, NO fma) and cvtps' round-to-nearest-even, so the output
// is bit-identical to hrow_scalar. Contiguous 8-byte stores.
__attribute__((target("avx2")))
void hrow_avx2(const float* trow, uint8_t* drow, const int32_t* off0,
               const int32_t* off1, const float* wx, int n) {
  const __m256 zero = _mm256_setzero_ps();
  const __m256 v255 = _mm256_set1_ps(255.0f);
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    __m256i i0 = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(off0 + j));
    __m256i i1 = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(off1 + j));
    __m256 a = _mm256_i32gather_ps(trow, i0, 4);
    __m256 b = _mm256_i32gather_ps(trow, i1, 4);
    __m256 f = _mm256_loadu_ps(wx + j);
    __m256 v = _mm256_add_ps(a, _mm256_mul_ps(_mm256_sub_ps(b, a), f));
    v = _mm256_min_ps(_mm256_max_ps(v, zero), v255);
    __m256i p32 = _mm256_cvtps_epi32(v);
    __m128i p16 = _mm_packs_epi32(_mm256_castsi256_si128(p32),
                                  _mm256_extracti128_si256(p32, 1));
    __m128i p8 = _mm_packus_epi16(p16, p16);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(drow + j), p8);
  }
  if (j < n) hrow_scalar(trow, drow + j, off0 + j, off1 + j, wx + j, n - j);
}
#endif

// Exact torch-bilinear resize (align_corners=False, NO antialias): 2-tap
// half-pixel sampling on both axes, float accumulation, one rint at the
// end. swscale's SWS_BILINEAR widens the filter on downscale (correct
// signal processing, but NOT the reference protocol —
// `transform.py:73-91` uses F.interpolate(bilinear), which aliases), so
// decode-time resize must use this kernel for checkpoint parity.
// src/dst are packed RGB24.
void resize_bilinear_exact_u8(const uint8_t* src, int sw, int sh,
                              uint8_t* dst, int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  // Per-output-element (x, ch) flat taps for the horizontal pass.
  std::vector<int32_t> off0(static_cast<size_t>(dw) * 3);
  std::vector<int32_t> off1(static_cast<size_t>(dw) * 3);
  std::vector<float> wx(static_cast<size_t>(dw) * 3);
  for (int x = 0; x < dw; ++x) {
    double s = (x + 0.5) * static_cast<double>(sw) / dw - 0.5;
    s = std::min(std::max(s, 0.0), static_cast<double>(sw - 1));
    int i0 = static_cast<int>(s);
    int i1 = std::min(i0 + 1, sw - 1);
    for (int ch = 0; ch < 3; ++ch) {
      off0[x * 3 + ch] = i0 * 3 + ch;
      off1[x * 3 + ch] = i1 * 3 + ch;
      wx[x * 3 + ch] = static_cast<float>(s - i0);
    }
  }
  std::vector<int> y0(dh), y1(dh);
  std::vector<float> fy(dh);
  for (int y = 0; y < dh; ++y) {
    double s = (y + 0.5) * static_cast<double>(sh) / dh - 0.5;
    s = std::min(std::max(s, 0.0), static_cast<double>(sh - 1));
    int i0 = static_cast<int>(s);
    y0[y] = i0;
    y1[y] = std::min(i0 + 1, sh - 1);
    fy[y] = static_cast<float>(s - i0);
  }
#if defined(__x86_64__) || defined(__i386__)
  // PMV_NO_AVX2=1 forces the scalar row kernel (exactness A/B in tests).
  static const bool kAvx2 = __builtin_cpu_supports("avx2") &&
                            (std::getenv("PMV_NO_AVX2") == nullptr);
  auto* hrow = kAvx2 ? hrow_avx2 : hrow_scalar;
  auto* vrow = kAvx2 ? vrow_avx2 : vrow_scalar;
#else
  auto* hrow = hrow_scalar;
  auto* vrow = vrow_scalar;
#endif
  // Vertical pass FIRST (contiguous row lerps, auto-vectorizes) so the
  // gather-bound horizontal pass touches dh rows instead of sh — this is
  // over half the whole decode cost on downscales (decode-throughput
  // microbench). Same separable math; f32 accumulation, one rint.
  std::vector<float> tmp(static_cast<size_t>(dh) * sw * 3);
  for (int y = 0; y < dh; ++y) {
    vrow(src + static_cast<size_t>(y0[y]) * sw * 3,
         src + static_cast<size_t>(y1[y]) * sw * 3,
         tmp.data() + static_cast<size_t>(y) * sw * 3, fy[y], sw * 3);
  }
  for (int y = 0; y < dh; ++y) {
    hrow(tmp.data() + static_cast<size_t>(y) * sw * 3,
         dst + static_cast<size_t>(y) * dw * 3, off0.data(), off1.data(),
         wx.data(), dw * 3);
  }
}

}  // namespace

extern "C" {

// Open a container and its best video stream. Returns nullptr on failure.
void* pmv_open(const char* path) {
  auto* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  d->stream_idx =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_idx < 0 || dec == nullptr) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_idx];
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec ||
      avcodec_parameters_to_context(d->codec, st->codecpar) < 0 ||
      avcodec_open2(d->codec, dec, nullptr) < 0) {
    if (d->codec) avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->fps = stream_fps(st);
  d->idx_fps = index_fps(st);
  d->nb_frames = st->nb_frames;
  if (st->duration > 0) {
    d->duration_sec = st->duration * av_q2d(st->time_base);
  } else if (d->fmt->duration > 0) {
    d->duration_sec = static_cast<double>(d->fmt->duration) / AV_TIME_BASE;
  }
  if (d->nb_frames <= 0 && d->fps > 0 && d->duration_sec > 0) {
    d->nb_frames = static_cast<int64_t>(d->duration_sec * d->fps);
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  return d;
}

int pmv_info(void* handle, double* fps, long long* nb_frames, int* width,
             int* height, double* duration_sec) {
  if (!handle) return -1;
  auto* d = static_cast<Decoder*>(handle);
  if (fps) *fps = d->fps;
  if (nb_frames) *nb_frames = d->nb_frames;
  if (width) *width = d->width;
  if (height) *height = d->height;
  if (duration_sec) *duration_sec = d->duration_sec;
  return 0;
}

// Decode `count` frames at the given (sorted, possibly repeated) frame
// indices, scale each to (out_w, out_h) RGB24 and write packed into `out`
// (count * out_h * out_w * 3 bytes). Seeks to the keyframe before the first
// index and decodes forward only through the window — the PTS-selective
// strategy of the reference pyav path (decoder.py:416-489).
int pmv_decode_frames(void* handle, const long long* indices, int count,
                      unsigned char* out, int out_w, int out_h) {
  if (!handle || count <= 0) return -1;
  auto* d = static_cast<Decoder*>(handle);
  if (d->fps <= 0) return -2;
  AVStream* st = d->fmt->streams[d->stream_idx];

  int64_t first = indices[0];
  int64_t last = indices[count - 1];
  for (int i = 0; i < count; ++i) {
    first = std::min<int64_t>(first, indices[i]);
    last = std::max<int64_t>(last, indices[i]);
  }

  // Seek to slightly before the first needed frame (backward keyframe).
  const double map_fps = d->idx_fps > 0 ? d->idx_fps : d->fps;
  double t0 = static_cast<double>(first) / map_fps;
  int64_t seek_ts = static_cast<int64_t>(t0 / av_q2d(st->time_base));
  av_seek_frame(d->fmt, d->stream_idx, seek_ts, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(d->codec);

  // Pixel-format conversion at NATIVE size; the resize to (out_w, out_h)
  // happens in resize_bilinear_exact_u8 (torch-protocol parity — swscale's
  // downscale filter is not the reference's 2-tap bilinear).
  SwsContext* sws = sws_getContext(
      d->width, d->height, d->codec->pix_fmt, d->width, d->height,
      AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) return -3;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int filled = 0;
  int64_t frame_count = -1;  // index of the most recently decoded frame
  bool started = false;
  double tb = av_q2d(st->time_base);
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;

  // Staging buffer with a 64-byte-aligned, padded stride: swscale's SIMD
  // row tails write past width*3 (measured 24 bytes on yuv420p->rgb24),
  // so its output never goes straight into the caller's packed buffer.
  const int stage_stride =
      static_cast<int>(((static_cast<size_t>(d->width) * 3 + 63) / 64) * 64);
  uint8_t* stage = static_cast<uint8_t*>(
      av_malloc(static_cast<size_t>(stage_stride) * d->height + 64));
  // Packed native-size RGB (input to the exact resize).
  uint8_t* native_rgb = static_cast<uint8_t*>(
      av_malloc(static_cast<size_t>(d->width) * d->height * 3));
  if (!stage || !native_rgb) {
    if (stage) av_free(stage);
    if (native_rgb) av_free(native_rgb);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    sws_freeContext(sws);
    return -4;
  }
  const bool needs_resize = (out_w != d->width || out_h != d->height);

  auto emit = [&](AVFrame* f, int64_t idx) {
    // Write f into every output slot whose requested index == idx.
    uint8_t* dst_data[4] = {stage, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {stage_stride, 0, 0, 0};
    bool scaled = false;
    for (int i = 0; i < count; ++i) {
      if (indices[i] == idx) {
        if (!scaled) {
          sws_scale(sws, f->data, f->linesize, 0, d->height, dst_data,
                    dst_linesize);
          // Pack rows (strip the alignment padding).
          for (int y = 0; y < d->height; ++y) {
            std::memcpy(native_rgb + static_cast<size_t>(y) * d->width * 3,
                        stage + static_cast<size_t>(y) * stage_stride,
                        static_cast<size_t>(d->width) * 3);
          }
          scaled = true;
        }
        uint8_t* dst = out + frame_bytes * i;
        if (needs_resize) {
          resize_bilinear_exact_u8(native_rgb, d->width, d->height, dst,
                                   out_w, out_h);
        } else {
          std::memcpy(dst, native_rgb, frame_bytes);
        }
        ++filled;
      }
    }
  };

  int ret = 0;
  while (filled < count && (ret = av_read_frame(d->fmt, pkt)) >= 0) {
    if (pkt->stream_index != d->stream_idx) {
      av_packet_unref(pkt);
      continue;
    }
    if (avcodec_send_packet(d->codec, pkt) == 0) {
      while (avcodec_receive_frame(d->codec, frame) == 0) {
        int64_t pts = frame->best_effort_timestamp;
        int64_t idx;
        if (pts != AV_NOPTS_VALUE) {
          idx = static_cast<int64_t>(std::llround(pts * tb * map_fps));
          started = true;
        } else {
          idx = started ? frame_count + 1 : 0;
        }
        frame_count = idx;
        if (idx >= first) emit(frame, idx);
        if (idx >= last) {
          filled = filled >= count ? filled : filled;  // keep draining below
        }
        av_frame_unref(frame);
        if (frame_count >= last && filled >= count) break;
      }
    }
    av_packet_unref(pkt);
    if (frame_count >= last && filled >= count) break;
    // Safety: if we've decoded well past the window, stop.
    if (frame_count > last + 64) break;
  }
  // Flush decoder for tail frames.
  if (filled < count) {
    avcodec_send_packet(d->codec, nullptr);
    while (avcodec_receive_frame(d->codec, frame) == 0) {
      int64_t pts = frame->best_effort_timestamp;
      int64_t idx = (pts != AV_NOPTS_VALUE)
                        ? static_cast<int64_t>(std::llround(pts * tb * map_fps))
                        : frame_count + 1;
      frame_count = idx;
      if (idx >= first) emit(frame, idx);
      av_frame_unref(frame);
      if (filled >= count) break;
    }
    avcodec_flush_buffers(d->codec);
  }
  // Clamp: indices are sorted and decode order is ascending, so unfilled
  // slots form a tail. Duplicate the last decoded frame into them (short
  // videos — matches the reference's linspace index clamping).
  if (filled < count && filled > 0) {
    for (int i = filled; i < count; ++i) {
      std::memcpy(out + frame_bytes * i, out + frame_bytes * (filled - 1),
                  frame_bytes);
    }
  }

  av_free(stage);
  av_free(native_rgb);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);
  return filled > 0 ? filled : -4;
}

// Decode the audio stream over [start_sec, start_sec + dur_sec), resampled
// to mono float32 at target_sr (the AVSlowFast pathway's input;
// reference: decoder_av.py audio extraction). Returns samples written,
// 0 if the container has no audio stream, <0 on error.
long long pmv_decode_audio(void* handle, double start_sec, double dur_sec,
                           int target_sr, float* out,
                           long long max_samples) {
  if (!handle) return -1;
  auto* d = static_cast<Decoder*>(handle);
  int astream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                    nullptr, 0);
  if (astream < 0) return 0;
  AVStream* st = d->fmt->streams[astream];
  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) return -2;
  AVCodecContext* actx = avcodec_alloc_context3(dec);
  if (!actx || avcodec_parameters_to_context(actx, st->codecpar) < 0 ||
      avcodec_open2(actx, dec, nullptr) < 0) {
    if (actx) avcodec_free_context(&actx);
    return -3;
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout = actx->ch_layout;
  if (in_layout.nb_channels == 0) av_channel_layout_default(&in_layout, 1);
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_sr,
                          &in_layout, actx->sample_fmt,
                          actx->sample_rate, 0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    avcodec_free_context(&actx);
    return -4;
  }

  int64_t seek_ts = static_cast<int64_t>(start_sec / av_q2d(st->time_base));
  av_seek_frame(d->fmt, astream, seek_ts, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(actx);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  long long written = 0;
  double end_sec = start_sec + dur_sec;
  std::vector<float> tmp(8192);
  bool done = false;
  while (!done && av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index != astream) {
      av_packet_unref(pkt);
      continue;
    }
    if (avcodec_send_packet(actx, pkt) == 0) {
      while (avcodec_receive_frame(actx, frame) == 0) {
        double t = frame->pts != AV_NOPTS_VALUE
                       ? frame->pts * av_q2d(st->time_base)
                       : start_sec;
        if (t >= end_sec) {
          done = true;
          av_frame_unref(frame);
          break;
        }
        int out_cap = static_cast<int>(tmp.size());
        uint8_t* outp = reinterpret_cast<uint8_t*>(tmp.data());
        int got = swr_convert(swr, &outp, out_cap,
                              const_cast<const uint8_t**>(frame->data),
                              frame->nb_samples);
        if (got > 0 && t + static_cast<double>(frame->nb_samples) /
                               std::max(actx->sample_rate, 1) > start_sec) {
          long long n = std::min<long long>(got, max_samples - written);
          if (n > 0) {
            std::memcpy(out + written, tmp.data(), n * sizeof(float));
            written += n;
          }
          if (written >= max_samples) done = true;
        }
        av_frame_unref(frame);
      }
    }
    av_packet_unref(pkt);
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&actx);
  return written;
}

// Direct entry to the exact-protocol resize (RGB24), for tests and the
// loader-side resample microbench.
void pmv_resize_bilinear(const unsigned char* src, int sw, int sh,
                         unsigned char* dst, int dw, int dh) {
  resize_bilinear_exact_u8(src, sw, sh, dst, dw, dh);
}

void pmv_close(void* handle) {
  if (!handle) return;
  auto* d = static_cast<Decoder*>(handle);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------------
// Raw AVI writer with optional PCM audio — lets tests synthesize real
// decodable A/V files without an encoder dependency.
int pmv_write_test_video_av(const char* path, const unsigned char* rgb,
                            int num_frames, int width, int height, int fps,
                            const float* audio, long long n_audio,
                            int audio_sr) {
  AVFormatContext* ofmt = nullptr;
  avformat_alloc_output_context2(&ofmt, nullptr, "avi", path);
  if (!ofmt) return -1;
  const AVCodec* vcodec = avcodec_find_encoder(AV_CODEC_ID_RAWVIDEO);
  AVStream* vst = avformat_new_stream(ofmt, vcodec);
  AVCodecContext* vc = avcodec_alloc_context3(vcodec);
  vc->codec_id = AV_CODEC_ID_RAWVIDEO;
  vc->width = width;
  vc->height = height;
  vc->pix_fmt = AV_PIX_FMT_BGR24;
  vc->time_base = AVRational{1, fps};
  vst->time_base = vc->time_base;
  if (avcodec_open2(vc, vcodec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(vst->codecpar, vc);

  AVCodecContext* ac = nullptr;
  AVStream* ast = nullptr;
  if (audio && n_audio > 0) {
    const AVCodec* acodec = avcodec_find_encoder(AV_CODEC_ID_PCM_S16LE);
    ast = avformat_new_stream(ofmt, acodec);
    ac = avcodec_alloc_context3(acodec);
    ac->sample_rate = audio_sr;
    av_channel_layout_default(&ac->ch_layout, 1);
    ac->sample_fmt = AV_SAMPLE_FMT_S16;
    ac->time_base = AVRational{1, audio_sr};
    ast->time_base = ac->time_base;
    if (avcodec_open2(ac, acodec, nullptr) < 0) return -6;
    avcodec_parameters_from_context(ast->codecpar, ac);
  }

  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(ofmt, nullptr) < 0) return -5;

  AVPacket* pkt = av_packet_alloc();

  // Video frames.
  AVFrame* frame = av_frame_alloc();
  frame->format = vc->pix_fmt;
  frame->width = width;
  frame->height = height;
  av_frame_get_buffer(frame, 0);
  const size_t fbytes = static_cast<size_t>(width) * height * 3;
  for (int i = 0; i < num_frames; ++i) {
    av_frame_make_writable(frame);
    const unsigned char* src = rgb + fbytes * i;
    for (int y = 0; y < height; ++y) {
      uint8_t* drow = frame->data[0] + y * frame->linesize[0];
      const unsigned char* srow = src + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        drow[x * 3 + 0] = srow[x * 3 + 2];
        drow[x * 3 + 1] = srow[x * 3 + 1];
        drow[x * 3 + 2] = srow[x * 3 + 0];
      }
    }
    frame->pts = i;
    if (avcodec_send_frame(vc, frame) == 0) {
      while (avcodec_receive_packet(vc, pkt) == 0) {
        av_packet_rescale_ts(pkt, vc->time_base, vst->time_base);
        pkt->stream_index = vst->index;
        av_interleaved_write_frame(ofmt, pkt);
        av_packet_unref(pkt);
      }
    }
  }
  av_frame_free(&frame);

  // Audio samples (one big PCM frame chunked).
  if (ac) {
    const int chunk = 4096;
    AVFrame* af = av_frame_alloc();
    for (long long pos = 0; pos < n_audio; pos += chunk) {
      int n = static_cast<int>(std::min<long long>(chunk, n_audio - pos));
      af->format = ac->sample_fmt;
      av_channel_layout_copy(&af->ch_layout, &ac->ch_layout);
      af->nb_samples = n;
      av_frame_get_buffer(af, 0);
      int16_t* dst = reinterpret_cast<int16_t*>(af->data[0]);
      for (int i = 0; i < n; ++i) {
        float v = audio[pos + i];
        v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
        dst[i] = static_cast<int16_t>(v * 32767.f);
      }
      af->pts = pos;
      if (avcodec_send_frame(ac, af) == 0) {
        while (avcodec_receive_packet(ac, pkt) == 0) {
          av_packet_rescale_ts(pkt, ac->time_base, ast->time_base);
          pkt->stream_index = ast->index;
          av_interleaved_write_frame(ofmt, pkt);
          av_packet_unref(pkt);
        }
      }
      av_frame_unref(af);
    }
    av_frame_free(&af);
  }

  av_write_trailer(ofmt);
  av_packet_free(&pkt);
  avcodec_free_context(&vc);
  if (ac) avcodec_free_context(&ac);
  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
  avformat_free_context(ofmt);
  return 0;
}

// H.264 MP4 writer (yuv420p, real GOP structure) — realistic corpora for
// decode-throughput measurement and PTS-seek tests: unlike the rawvideo
// writer, decoding these costs actual codec work and selective seek must
// land on keyframes (the reference corpus is H.264 mp4, `DATA.md:6`).
int pmv_write_video_h264(const char* path, const unsigned char* rgb,
                         int num_frames, int width, int height, int fps,
                         int gop, int qp) {
  AVFormatContext* ofmt = nullptr;
  avformat_alloc_output_context2(&ofmt, nullptr, "mp4", path);
  if (!ofmt) return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (!codec) return -2;
  AVStream* st = avformat_new_stream(ofmt, codec);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->codec_id = AV_CODEC_ID_H264;
  c->width = width;
  c->height = height;
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = AVRational{1, fps};
  c->framerate = AVRational{fps, 1};
  c->gop_size = gop > 0 ? gop : 30;
  c->max_b_frames = 2;
  if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary* opts = nullptr;
  char qpstr[16];
  snprintf(qpstr, sizeof qpstr, "%d", qp > 0 ? qp : 23);
  av_dict_set(&opts, "crf", qpstr, 0);       // libx264
  av_dict_set(&opts, "qp", qpstr, 0);        // openh264 fallback
  av_dict_set(&opts, "preset", "veryfast", 0);
  if (avcodec_open2(c, codec, &opts) < 0) {
    av_dict_free(&opts);
    return -3;
  }
  av_dict_free(&opts);
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(ofmt, nullptr) < 0) return -5;

  SwsContext* sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width,
                                   height, AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                                   nullptr, nullptr, nullptr);
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  frame->format = c->pix_fmt;
  frame->width = width;
  frame->height = height;
  av_frame_get_buffer(frame, 0);
  const size_t fbytes = static_cast<size_t>(width) * height * 3;
  auto drain = [&](AVCodecContext* ctx) {
    while (avcodec_receive_packet(ctx, pkt) == 0) {
      // x264 leaves pkt->duration 0; without it the mp4 muxer computes the
      // track duration from dts span only, which lands the last (B-frame
      // reordered) sample's pts outside the edit list — every demuxer then
      // silently discards the final frame.
      if (pkt->duration == 0) pkt->duration = 1;
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(ofmt, pkt);
      av_packet_unref(pkt);
    }
  };
  for (int i = 0; i < num_frames; ++i) {
    av_frame_make_writable(frame);
    const uint8_t* src[1] = {rgb + fbytes * i};
    const int src_stride[1] = {width * 3};
    sws_scale(sws, src, src_stride, 0, height, frame->data, frame->linesize);
    frame->pts = i;
    // send_frame returns EAGAIN (frame NOT consumed) when the encoder has
    // pending output — drain and retry, else the frame is silently dropped
    // (x264's lookahead hit this every ~32 frames).
    for (int tries = 0; tries < 64; ++tries) {
      int s = avcodec_send_frame(c, frame);
      if (s == 0) break;
      if (s != AVERROR(EAGAIN)) break;
      drain(c);
    }
    drain(c);
  }
  avcodec_send_frame(c, nullptr);  // flush
  drain(c);
  av_write_trailer(ofmt);
  sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&c);
  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
  avformat_free_context(ofmt);
  return 0;
}

// Raw RGB24 AVI writer — kept for backward compatibility of the binding.
int pmv_write_test_video(const char* path, const unsigned char* rgb,
                         int num_frames, int width, int height, int fps) {
  AVFormatContext* ofmt = nullptr;
  avformat_alloc_output_context2(&ofmt, nullptr, "avi", path);
  if (!ofmt) return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_RAWVIDEO);
  if (!codec) return -2;
  AVStream* st = avformat_new_stream(ofmt, codec);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->codec_id = AV_CODEC_ID_RAWVIDEO;
  c->width = width;
  c->height = height;
  c->pix_fmt = AV_PIX_FMT_BGR24;
  c->time_base = AVRational{1, fps};
  st->time_base = c->time_base;
  if (avcodec_open2(c, codec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, c);
  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(ofmt, nullptr) < 0) return -5;

  AVFrame* frame = av_frame_alloc();
  frame->format = c->pix_fmt;
  frame->width = width;
  frame->height = height;
  av_frame_get_buffer(frame, 0);
  AVPacket* pkt = av_packet_alloc();
  const size_t fbytes = static_cast<size_t>(width) * height * 3;
  for (int i = 0; i < num_frames; ++i) {
    av_frame_make_writable(frame);
    // RGB -> BGR swizzle row-by-row into the frame buffer.
    const unsigned char* src = rgb + fbytes * i;
    for (int y = 0; y < height; ++y) {
      uint8_t* drow = frame->data[0] + y * frame->linesize[0];
      const unsigned char* srow = src + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        drow[x * 3 + 0] = srow[x * 3 + 2];
        drow[x * 3 + 1] = srow[x * 3 + 1];
        drow[x * 3 + 2] = srow[x * 3 + 0];
      }
    }
    frame->pts = i;
    if (avcodec_send_frame(c, frame) == 0) {
      while (avcodec_receive_packet(c, pkt) == 0) {
        av_packet_rescale_ts(pkt, c->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(ofmt, pkt);
        av_packet_unref(pkt);
      }
    }
  }
  avcodec_send_frame(c, nullptr);
  while (avcodec_receive_packet(c, pkt) == 0) {
    av_packet_rescale_ts(pkt, c->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(ofmt, pkt);
    av_packet_unref(pkt);
  }
  av_write_trailer(ofmt);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  avcodec_free_context(&c);
  if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
  avformat_free_context(ofmt);
  return 0;
}

}  // extern "C"
