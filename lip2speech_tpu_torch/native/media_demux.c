/* In-process audio demux/decode via the system libav (libavformat ->
 * libavcodec -> libswresample): the reference's `ffmpeg -i video -vn -ac 1
 * -ar SR` extract-audio subprocess (reference config.py
 * EXTRACT_AUDIO_COMMAND / video_to_audio paths) without the ffmpeg binary.
 * The port's copy of the JAX package's native/media_demux.c.
 *
 * Exported API (ctypes, see native/__init__.py):
 *   long l2s_decode_audio(const char *path, int target_sr,
 *                         float **out, long *out_len);
 *       Decodes the FIRST audio stream to mono float32 at target_sr.
 *       Returns 0 on success (caller owns *out via l2s_free), <0 on error:
 *       -1 open/stream errors, -2 no audio stream, -3 decoder missing,
 *       -4 resampler init, -5 decode error, -6 alloc failure.
 *   void l2s_free(float *buf);
 *
 * Build: cc -O2 -shared -fPIC media_demux.c -lavformat -lavcodec -lavutil
 *        -lswresample
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>

typedef struct {
    float *data;
    long len;   /* samples */
    long cap;
} buf_t;

static int buf_push(buf_t *b, const float *src, long n) {
    if (b->len + n > b->cap) {
        long cap = b->cap ? b->cap * 2 : 65536;
        while (cap < b->len + n) cap *= 2;
        float *p = (float *)realloc(b->data, (size_t)cap * sizeof(float));
        if (!p) return -1;
        b->data = p;
        b->cap = cap;
    }
    memcpy(b->data + b->len, src, (size_t)n * sizeof(float));
    b->len += n;
    return 0;
}

/* drain all resampled mono samples for one decoded frame (or flush when
 * frame == NULL) into buf */
static int drain_swr(SwrContext *swr, const AVFrame *frame, int target_sr,
                     buf_t *buf, float *tmp, int tmp_cap) {
    const uint8_t **in = frame ? (const uint8_t **)frame->extended_data : NULL;
    int in_n = frame ? frame->nb_samples : 0;
    for (;;) {
        uint8_t *outp = (uint8_t *)tmp;
        int got = swr_convert(swr, &outp, tmp_cap, in, in_n);
        if (got < 0) return -5;
        if (got > 0 && buf_push(buf, tmp, got) != 0) return -6;
        in = NULL;   /* only feed the input once */
        in_n = 0;
        if (got < tmp_cap) return 0;   /* drained */
    }
    (void)target_sr;
}

long l2s_decode_audio(const char *path, int target_sr, float **out,
                      long *out_len) {
    AVFormatContext *fmt = NULL;
    AVCodecContext *dec = NULL;
    SwrContext *swr = NULL;
    AVPacket *pkt = NULL;
    AVFrame *frame = NULL;
    float *tmp = NULL;
    buf_t buf = {0, 0, 0};
    long rc = -1;
    int stream_idx = -1;

    *out = NULL;
    *out_len = 0;

    if (avformat_open_input(&fmt, path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(fmt, NULL) < 0) goto done;

    const AVCodec *codec = NULL;
    stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                     &codec, 0);
    if (stream_idx < 0) { rc = -2; goto done; }
    if (!codec) { rc = -3; goto done; }

    dec = avcodec_alloc_context3(codec);
    if (!dec) { rc = -6; goto done; }
    if (avcodec_parameters_to_context(dec,
                                      fmt->streams[stream_idx]->codecpar) < 0
        || avcodec_open2(dec, codec, NULL) < 0) { rc = -3; goto done; }

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    AVChannelLayout in_layout;
    if (dec->ch_layout.nb_channels > 0) {
        av_channel_layout_copy(&in_layout, &dec->ch_layout);
    } else {
        av_channel_layout_default(&in_layout, 1);
    }
    if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_sr,
                            &in_layout, dec->sample_fmt,
                            dec->sample_rate, 0, NULL) < 0
        || swr_init(swr) < 0) { rc = -4; goto done; }
    av_channel_layout_uninit(&in_layout);

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    /* worst-case per-frame output: frame samples rescaled + swr delay */
    int tmp_cap = target_sr * 4;
    tmp = (float *)malloc((size_t)tmp_cap * sizeof(float));
    if (!pkt || !frame || !tmp) { rc = -6; goto done; }

    while (av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == stream_idx) {
            if (avcodec_send_packet(dec, pkt) == 0) {
                while (avcodec_receive_frame(dec, frame) == 0) {
                    int r = drain_swr(swr, frame, target_sr, &buf, tmp,
                                      tmp_cap);
                    if (r < 0) { rc = r; av_packet_unref(pkt); goto done; }
                }
            }
        }
        av_packet_unref(pkt);
    }
    /* flush decoder then resampler */
    avcodec_send_packet(dec, NULL);
    while (avcodec_receive_frame(dec, frame) == 0) {
        int r = drain_swr(swr, frame, target_sr, &buf, tmp, tmp_cap);
        if (r < 0) { rc = r; goto done; }
    }
    {
        int r = drain_swr(swr, NULL, target_sr, &buf, tmp, tmp_cap);
        if (r < 0) { rc = r; goto done; }
    }

    *out = buf.data;
    *out_len = buf.len;
    buf.data = NULL;
    rc = 0;

done:
    free(tmp);
    free(buf.data);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    return rc;
}

void l2s_free(float *buf) { free(buf); }

/* Container probe: returns sample rate of the first audio stream (>0),
 * -2 when the container has no audio stream, -1 on open error. Lets the
 * Python side distinguish "silent video" from "decode failure". */
long l2s_probe_audio(const char *path) {
    AVFormatContext *fmt = NULL;
    long rc;
    if (avformat_open_input(&fmt, path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(fmt, NULL) < 0) { rc = -1; goto done; }
    int idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, NULL, 0);
    if (idx < 0) { rc = -2; goto done; }
    rc = fmt->streams[idx]->codecpar->sample_rate;
done:
    avformat_close_input(&fmt);
    return rc;
}
