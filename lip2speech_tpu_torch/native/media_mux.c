/* In-process audio-over-video muxing via the system libav: the reference's
 * listening-copy overlay (`ffmpeg -i video -i wav -map 0:v -map 1:a
 * -c:v copy -shortest out.mp4`, reference overlay.py:12-71 /
 * COMBINE_AUDIO_AND_VIDEO_COMMAND) without the ffmpeg binary. The port's
 * copy of the JAX package's native/media_mux.c.
 *
 * Strategy: stream-copy the input's video packets untouched, encode the
 * caller's float32 mono PCM to AAC, stop the audio at the video's end
 * (-shortest). av_interleaved_write_frame handles packet ordering.
 *
 * Exported API:
 *   long l2s_mux_overlay(const char *video_path, const float *audio,
 *                        long n_samples, int sr, const char *out_path);
 *     0 on success; <0 on error: -1 open input, -2 no video stream,
 *     -3 output alloc/open, -4 AAC encoder, -5 header/trailer,
 *     -6 packet write, -7 allocation.
 *
 * Build: cc -O2 -shared -fPIC media_mux.c -lavformat -lavcodec -lavutil
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/mathematics.h>

static int write_audio_packets(AVFormatContext *ofmt, AVCodecContext *enc,
                               AVStream *astream, AVPacket *pkt) {
    for (;;) {
        int r = avcodec_receive_packet(enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
        if (r < 0) return -6;
        pkt->stream_index = astream->index;
        av_packet_rescale_ts(pkt, enc->time_base, astream->time_base);
        if (av_interleaved_write_frame(ofmt, pkt) < 0) return -6;
    }
}

long l2s_mux_overlay(const char *video_path, const float *audio,
                     long n_samples, int sr, const char *out_path) {
    AVFormatContext *in = NULL, *out = NULL;
    AVCodecContext *enc = NULL;
    AVFrame *frame = NULL;
    AVPacket *pkt = NULL;
    long rc = -1;
    int vin = -1;
    double video_end_s = 0.0;

    if (avformat_open_input(&in, video_path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(in, NULL) < 0) goto done;
    vin = av_find_best_stream(in, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
    if (vin < 0) { rc = -2; goto done; }

    if (avformat_alloc_output_context2(&out, NULL, NULL, out_path) < 0
        || !out) { rc = -3; goto done; }

    /* video: stream copy */
    AVStream *vstream = avformat_new_stream(out, NULL);
    if (!vstream) { rc = -7; goto done; }
    if (avcodec_parameters_copy(vstream->codecpar,
                                in->streams[vin]->codecpar) < 0) {
        rc = -7; goto done;
    }
    vstream->codecpar->codec_tag = 0;
    vstream->time_base = in->streams[vin]->time_base;

    /* audio: AAC-encode the PCM */
    const AVCodec *acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (!acodec) { rc = -4; goto done; }
    enc = avcodec_alloc_context3(acodec);
    if (!enc) { rc = -7; goto done; }
    enc->sample_rate = sr;
    av_channel_layout_default(&enc->ch_layout, 1);
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;   /* native aac encoder format */
    enc->bit_rate = 96000;
    enc->time_base = (AVRational){1, sr};
    if (out->oformat->flags & AVFMT_GLOBALHEADER)
        enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, acodec, NULL) < 0) { rc = -4; goto done; }
    AVStream *astream = avformat_new_stream(out, NULL);
    if (!astream) { rc = -7; goto done; }
    if (avcodec_parameters_from_context(astream->codecpar, enc) < 0) {
        rc = -7; goto done;
    }
    astream->time_base = enc->time_base;

    if (!(out->oformat->flags & AVFMT_NOFILE)
        && avio_open(&out->pb, out_path, AVIO_FLAG_WRITE) < 0) {
        rc = -3; goto done;
    }
    if (avformat_write_header(out, NULL) < 0) { rc = -5; goto done; }

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) { rc = -7; goto done; }

    /* 1. copy every video packet; track the stream's end time */
    while (av_read_frame(in, pkt) >= 0) {
        if (pkt->stream_index == vin) {
            int64_t end_ts = (pkt->pts == AV_NOPTS_VALUE ? 0 : pkt->pts)
                             + (pkt->duration > 0 ? pkt->duration : 0);
            double t = end_ts * av_q2d(in->streams[vin]->time_base);
            if (t > video_end_s) video_end_s = t;
            pkt->stream_index = vstream->index;
            av_packet_rescale_ts(pkt, in->streams[vin]->time_base,
                                 vstream->time_base);
            pkt->pos = -1;
            if (av_interleaved_write_frame(out, pkt) < 0) {
                rc = -6; av_packet_unref(pkt); goto done;
            }
        }
        av_packet_unref(pkt);
    }

    /* 2. encode audio up to min(n_samples, video end)  (-shortest) */
    long limit = n_samples;
    if (video_end_s > 0) {
        long vs = (long)(video_end_s * sr + 0.5);
        if (vs < limit) limit = vs;
    }
    int fsz = enc->frame_size > 0 ? enc->frame_size : 1024;
    long pos = 0;
    while (pos < limit) {
        int n = (int)(limit - pos < fsz ? limit - pos : fsz);
        frame->nb_samples = n;
        frame->format = AV_SAMPLE_FMT_FLTP;
        av_channel_layout_default(&frame->ch_layout, 1);
        frame->sample_rate = sr;
        if (av_frame_get_buffer(frame, 0) < 0) { rc = -7; goto done; }
        memcpy(frame->data[0], audio + pos, (size_t)n * sizeof(float));
        frame->pts = pos;
        pos += n;
        if (avcodec_send_frame(enc, frame) < 0) { rc = -6; goto done; }
        av_frame_unref(frame);
        int r = write_audio_packets(out, enc, astream, pkt);
        if (r < 0) { rc = r; goto done; }
    }
    avcodec_send_frame(enc, NULL);   /* flush */
    {
        int r = write_audio_packets(out, enc, astream, pkt);
        if (r < 0) { rc = r; goto done; }
    }

    if (av_write_trailer(out) < 0) { rc = -5; goto done; }
    rc = 0;

done:
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (enc) avcodec_free_context(&enc);
    if (out) {
        if (!(out->oformat->flags & AVFMT_NOFILE) && out->pb)
            avio_closep(&out->pb);
        avformat_free_context(out);
    }
    if (in) avformat_close_input(&in);
    return rc;
}
