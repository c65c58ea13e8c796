// Native video decoder: libavformat/libavcodec -> RGB24 frame batches.
//
// The TPU-native replacement for decord (SURVEY.md §2.2 N8): demux + decode
// + swscale on the host, handing (N, H, W, 3) uint8 frame batches to the
// input pipeline. C ABI for ctypes (timeviper_tpu/data/native_video.py).
//
// Build: g++ -O2 -shared -fPIC -o libvideodec.so videodec.cpp \
//          $(pkg-config --cflags --libs libavformat libavcodec libswscale libavutil) -lpthread

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

struct Ctx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  int64_t nb_frames = 0;
  double duration = 0.0;
};

void close_ctx(Ctx* c) {
  if (!c) return;
  if (c->sws) sws_freeContext(c->sws);
  if (c->dec) avcodec_free_context(&c->dec);
  if (c->fmt) avformat_close_input(&c->fmt);
  delete c;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr.
void* vd_open(const char* path) {
  av_log_set_level(AV_LOG_ERROR);
  Ctx* c = new Ctx();
  if (avformat_open_input(&c->fmt, path, nullptr, nullptr) < 0) {
    close_ctx(c);
    return nullptr;
  }
  if (avformat_find_stream_info(c->fmt, nullptr) < 0) {
    close_ctx(c);
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  c->stream_idx =
      av_find_best_stream(c->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (c->stream_idx < 0 || !codec) {
    close_ctx(c);
    return nullptr;
  }
  AVStream* st = c->fmt->streams[c->stream_idx];
  c->dec = avcodec_alloc_context3(codec);
  if (!c->dec ||
      avcodec_parameters_to_context(c->dec, st->codecpar) < 0 ||
      avcodec_open2(c->dec, codec, nullptr) < 0) {
    close_ctx(c);
    return nullptr;
  }
  c->width = c->dec->width;
  c->height = c->dec->height;
  AVRational fr = av_guess_frame_rate(c->fmt, st, nullptr);
  c->fps = fr.den ? static_cast<double>(fr.num) / fr.den : 30.0;
  c->duration = (c->fmt->duration != AV_NOPTS_VALUE)
                    ? static_cast<double>(c->fmt->duration) / AV_TIME_BASE
                    : 0.0;
  c->nb_frames = st->nb_frames;
  if (c->nb_frames <= 0 && c->duration > 0)
    c->nb_frames = static_cast<int64_t>(c->duration * c->fps);
  return c;
}

void vd_info(void* handle, int* width, int* height, double* fps,
             long long* nb_frames, double* duration) {
  Ctx* c = static_cast<Ctx*>(handle);
  *width = c->width;
  *height = c->height;
  *fps = c->fps;
  *nb_frames = c->nb_frames;
  *duration = c->duration;
}

// Decode the frames at `indices` (sorted ascending, frame numbers from 0)
// into out (n, out_h, out_w, 3) uint8 RGB. Returns frames written.
int vd_read_frames(void* handle, const long long* indices, int n,
                   unsigned char* out, int out_h, int out_w) {
  Ctx* c = static_cast<Ctx*>(handle);
  if (n <= 0) return 0;
  c->sws = sws_getCachedContext(
      c->sws, c->width, c->height, c->dec->pix_fmt, out_w, out_h,
      AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!c->sws) return 0;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int want = 0;       // next index position to satisfy
  int64_t cur = 0;    // current decoded frame number
  int written = 0;

  // sequential decode; sampled reads are monotone so this is one pass
  while (want < n && av_read_frame(c->fmt, pkt) >= 0) {
    if (pkt->stream_index != c->stream_idx) {
      av_packet_unref(pkt);
      continue;
    }
    if (avcodec_send_packet(c->dec, pkt) == 0) {
      while (avcodec_receive_frame(c->dec, frame) == 0) {
        while (want < n && indices[want] < cur) ++want;  // skip stale asks
        if (want < n && cur == indices[want]) {
          unsigned char* dst_data[4] = {
              out + static_cast<size_t>(written) * out_h * out_w * 3,
              nullptr, nullptr, nullptr};
          int dst_linesize[4] = {out_w * 3, 0, 0, 0};
          sws_scale(c->sws, frame->data, frame->linesize, 0, c->height,
                    dst_data, dst_linesize);
          ++written;
          ++want;
        }
        ++cur;
        if (want >= n) break;
      }
    }
    av_packet_unref(pkt);
  }
  // flush decoder
  if (want < n && avcodec_send_packet(c->dec, nullptr) == 0) {
    while (want < n && avcodec_receive_frame(c->dec, frame) == 0) {
      while (want < n && indices[want] < cur) ++want;
      if (want < n && cur == indices[want]) {
        unsigned char* dst_data[4] = {
            out + static_cast<size_t>(written) * out_h * out_w * 3, nullptr,
            nullptr, nullptr};
        int dst_linesize[4] = {out_w * 3, 0, 0, 0};
        sws_scale(c->sws, frame->data, frame->linesize, 0, c->height,
                  dst_data, dst_linesize);
        ++written;
        ++want;
      }
      ++cur;
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return written;
}

void vd_close(void* handle) { close_ctx(static_cast<Ctx*>(handle)); }

}  // extern "C"
