"""The port stands alone: lip2speech_tpu_torch and chip_smoke.py import
neither JAX/flax nor the JAX package, the kernels build only at first CUDA
use, and entry points never drop to the CPU on their own."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "lip2speech_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lip2speech_tpu")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"


def test_port_has_the_slice_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("core/config", "ops/nn", "ops/rel_attention", "ops/fused_tail",
                "models/layers", "models/resnet3d", "models/conformer",
                "models/multi_target", "models/vocoder", "decode/units",
                "convert/from_jax", "pipeline/synthesise", "kernels/build",
                "ops/attention", "ops/kmeans", "models/avhubert", "models/hubert",
                "data/manifest", "utils/audio_io", "pipeline/units_extract",
                "ops/dropout_mask", "train/losses", "train/stage1", "ops/dsp",
                "train/stage2", "data/stage2", "data/transforms", "data/video_io",
                "data/stage1", "data/prefetch", "train/checkpoint", "convert/from_reference",
                "utils/metrics_log", "cli/train_stage1", "cli/train_stage2", "cli/infer",
                "cli/vocode", "cli/convert", "pipeline/db", "utils/email_client", "eval/asr",
                "ops/denoise", "models/speaker", "pipeline/mouth_crop", "pipeline/haar",
                "pipeline/ert", "pipeline/landmarks", "ops/warp", "pipeline/batcher",
                "pipeline/server", "pipeline/streaming", "data/text", "native/__init__",
                "eval/metrics", "eval/pesq_p862", "models/transformer_decoder", "decode/beam",
                "models/avhubert_asr", "models/lm", "decode/ctc_joint", "models/raven_asr",
                "eval/asr_eval", "cli/infer_asr", "eval/harness", "utils/profiling",
                "ops/masking", "models/avhubert_pretrain", "models/resnet1d",
                "models/shufflenet", "models/vq", "pipeline/media", "cli/create_dataset",
                "cli/find_max_duration", "cli/overlay", "cli/shape_predictor",
                "data/spm_train", "cli/gen_subword", "cli/avspeech"):
        assert f"lip2speech_tpu_torch/{mod}.py" in names
    csrc = {p.name for p in (REPO / "lip2speech_tpu_torch" / "csrc").iterdir()}
    native = {p.name for p in (REPO / "lip2speech_tpu_torch" / "native").iterdir()}
    assert {"editdistance.c", "ctc_beam.c", "media_demux.c", "media_mux.c"} <= native
    assert {"rel_attention.cu", "fused_tail.cu", "attention.cu", "rel_attention_bias.cu",
            "flash_tile.cuh", "rel_attention_bwd.cu", "rel_attention_bias_bwd.cu",
            "flash_bwd_tile.cuh", "philox.cuh", "mma_tile.cuh"} <= csrc


def test_the_package_files_match_the_jax_package_but_on_purpose():
    """The .py / .c files of the two packages differ only where they should:
    the Pallas kernels (CUDA sources and their ops modules here), the two
    modules that need no counterpart, and the port's own additions."""
    def files(pkg):
        root = REPO / pkg
        return {str(p.relative_to(root)) for p in root.rglob("*") if p.suffix in (".py", ".c")
                and "_build" not in p.parts}

    jax_only = files("lip2speech_tpu") - files("lip2speech_tpu_torch")
    port_only = files("lip2speech_tpu_torch") - files("lip2speech_tpu")
    assert jax_only == {"ops/pallas_attention.py", "ops/pallas_rel_attention.py",
                        "ops/pallas_fused_tail.py", "ops/fold_conv.py",
                        "convert/torch_to_jax.py"}
    assert port_only == {"ops/attention.py", "ops/rel_attention.py", "ops/fused_tail.py",
                         "ops/dropout_mask.py", "kernels/__init__.py", "kernels/build.py",
                         "convert/from_jax.py", "convert/from_reference.py",
                         "parallel/collectives.py"}


def test_the_orbax_script_takes_only_the_restore_from_the_jax_package():
    """scripts/orbax_to_torch.py, the one file that imports both packages:
    the JAX side restores the orbax tree (train.checkpoint.load_pytree);
    every conversion is the port's."""
    path = REPO / "scripts" / "orbax_to_torch.py"
    tree = ast.parse(path.read_text())
    jax_side = {(n.module, a.name) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                and n.module and n.module.split(".")[0] == "lip2speech_tpu" for a in n.names}
    assert jax_side == {("lip2speech_tpu.train.checkpoint", "load_pytree")}
    roots = {name.split(".")[0] for name in _imported_modules(path)}
    assert roots & set(FORBIDDEN) == {"lip2speech_tpu"}
    assert "lip2speech_tpu_torch" in roots


def _with_headers(csrc, name: str) -> str:
    """The text of csrc/<name> and of the csrc headers it includes,
    transitively."""
    seen, todo, text = set(), [name], ""
    while todo:
        n = todo.pop()
        if n in seen or not (csrc / n).exists():
            continue
        seen.add(n)
        t = (csrc / n).read_text()
        text += t
        todo += re.findall(r'#include "([^"]+)"', t)
    return text


def test_every_kernel_source_names_what_it_replaces():
    """Each compiled source states the TPU kernel it replaces, and the four
    rel-position attention kernels share one dropout generator, used in the
    kernel's source or in a header it includes (the forward's loop lives in
    flash_fwd_hopper.cuh, the keep-bit drawing of both wgmma kernels in
    hopper.cuh)."""
    csrc = REPO / "lip2speech_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert len(sources) == 6
    for src in sources:
        assert "Replaces: lip2speech_tpu/ops/pallas_" in src.read_text(), src.name
    for name in ("rel_attention", "rel_attention_bias", "rel_attention_bwd",
                 "rel_attention_bias_bwd"):
        text = _with_headers(csrc, f"{name}.cu")
        assert "philox::Dropout" in text, name
        assert any(f in text for f in ("keep_tile", "pv_product_dropout", "keep_frag",
                                       "keep_half")), name
    assert '#include "philox.cuh"' in (csrc / "flash_tile.cuh").read_text()


def test_training_without_cuda_raises_unless_cpu_requested(monkeypatch):
    from lip2speech_tpu_torch.core.config import PipelineConfig
    from lip2speech_tpu_torch.train import stage1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.create_train_state(PipelineConfig())


def test_pipeline_without_cuda_raises_unless_cpu_requested(monkeypatch):
    from lip2speech_tpu_torch.pipeline import synthesise

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesise.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesise.Lip2SpeechPipeline(None, {}, {})
    assert synthesise.resolve_device("cpu") == torch.device("cpu")


def test_server_without_cuda_raises_unless_cpu_requested(monkeypatch):
    """make_server builds its random pipeline on the card unless
    device="cpu"; the device ops that take a tensor (preprocess_audio) or
    hold weights (SpeakerEncoder) follow the device of their input, and the
    device crop follows resolve_device."""
    from lip2speech_tpu_torch.core.config import preset
    from lip2speech_tpu_torch.models.speaker import SpeakerEncoder, embed_utterance
    from lip2speech_tpu_torch.ops import denoise, warp
    from lip2speech_tpu_torch.pipeline import server
    from lip2speech_tpu_torch.pipeline.mouth_crop import default_mean_face

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.make_server(port=0, cfg=preset("tiny"))
    mean = default_mean_face()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warp.crop_mouth_sequence_device(torch.zeros(2, 256, 256).numpy(), [mean, mean], mean)
    srv = server.make_server(port=0, cfg=preset("tiny"), device="cpu")
    try:
        state = srv.RequestHandlerClass.state
        assert state.pipeline.device == torch.device("cpu")
        with pytest.raises(ValueError, match="device only applies"):
            server.make_server(port=0, pipelines=state.pipelines, device="cpu")
    finally:
        srv.server_close()
        state.close()
    assert denoise.preprocess_audio(torch.ones(4_000)).device == torch.device("cpu")
    assert embed_utterance(SpeakerEncoder(), torch.zeros(4_000).numpy()).shape == (256,)


def test_unit_extraction_without_cuda_raises_unless_cpu_requested(monkeypatch):
    from lip2speech_tpu_torch.ops import kmeans
    from lip2speech_tpu_torch.pipeline import units_extract

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        units_extract.HubertFeatureExtractor({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        units_extract.HubertFeatureExtractor.initialize_random()
    x = torch.zeros(3, 4).numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.kmeans_apply(x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.kmeans_fit(x, n_clusters=2)
    assert kmeans.kmeans_apply(x, x, device="cpu").shape == (3,)


def test_asr_without_cuda_raises_unless_cpu_requested(monkeypatch, tmp_path):
    """infer_asr and evaluate_asr run on the card unless device="cpu"."""
    from lip2speech_tpu_torch.cli import infer_asr
    from lip2speech_tpu_torch.eval.asr_eval import evaluate_asr
    from lip2speech_tpu_torch.models.avhubert_asr import AVHubertSeq2Seq, Seq2SeqConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_asr.main(["--tsv", str(tmp_path / "none.tsv"), "--out-dir", str(tmp_path)])
    model = AVHubertSeq2Seq(Seq2SeqConfig(vocab_size=39, encoder_dim=16, encoder_heads=2,
                                          encoder_ffn_dim=16, encoder_layers=1, decoder_dim=16,
                                          decoder_heads=2, decoder_ffn_dim=16, decoder_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_asr(model, tmp_path / "none.tsv", {})


def test_dataset_tools_without_cuda_raise_unless_cpu_requested(monkeypatch, tmp_path):
    """create_dataset init, find_max_duration and overlay's denoise run on
    the card unless --device cpu."""
    from lip2speech_tpu_torch.cli import create_dataset, find_max_duration, overlay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "wavs").mkdir()
    for main, argv in (
            (create_dataset.main, ["init", "--videos", "v.npy", "--out-root", str(tmp_path)]),
            (find_max_duration.main, ["--preset", "tiny"]),
            (overlay.main, ["--video-dir", str(tmp_path), "--pred-wav-dir",
                            str(tmp_path / "wavs"), "--out-dir", str(tmp_path / "o"),
                            "--denoise-and-normalise"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_import_and_cpu_path_need_no_nvcc(tmp_path):
    """Importing the kernel modules and running their CPU paths builds and
    loads nothing (nvcc is unreachable in the child process); importing the
    recognition path builds no native helper."""
    code = (
        "import torch\n"
        "from lip2speech_tpu_torch.kernels import build\n"
        "from lip2speech_tpu_torch.ops import attention, fused_tail, rel_attention\n"
        "x = torch.randn(1, 2, 5, 4)\n"
        "p = torch.randn(2, 9, 4)\n"
        "m = torch.ones(1, 5, dtype=torch.bool)\n"
        "rel_attention.rel_attention(x, x, x, x, p, m)\n"
        "rel_attention.rel_attention(x, x, x, x, p, m, impl='bias')\n"
        "attention.attention(x, x, x, m)\n"
        "attention.attention(x, x, x, None)\n"
        "w = [[((torch.randn(16, 16, 3), torch.zeros(16)),) * 2]]\n"
        "fused_tail.fused_resblock_trio(torch.randn(1, 16, 9), w, (3,), ((1,),))\n"
        "q = x.clone().requires_grad_()\n"
        "rel_attention.rel_attention(q, x, x, x, p, m, dropout_rate=0.1, seed=1).sum().backward()\n"
        "rel_attention.rel_attention(q, x, x, x, p, m, impl='bias', dropout_rate=0.1).sum().backward()\n"
        "attention.attention(q, x, x, m).sum().backward()\n"
        "from lip2speech_tpu_torch.train import losses, stage1, stage2\n"
        "from lip2speech_tpu_torch.ops import dsp\n"
        "dsp.mel_spectrogram_hifigan(torch.randn(2, 2000))\n"
        "from lip2speech_tpu_torch.pipeline import server, streaming, batcher, landmarks\n"
        "from lip2speech_tpu_torch.ops import denoise, warp\n"
        "from lip2speech_tpu_torch.models import speaker\n"
        "from lip2speech_tpu_torch import native\n"
        "from lip2speech_tpu_torch.cli import infer_asr\n"
        "from lip2speech_tpu_torch.eval import asr_eval, harness, metrics\n"
        "from lip2speech_tpu_torch.models import avhubert_asr, lm, raven_asr\n"
        "from lip2speech_tpu_torch.pipeline import media\n"
        "from lip2speech_tpu_torch.cli import create_dataset, find_max_duration, overlay\n"
        "assert not build._libs and not native._LIBS\n"
        "assert rel_attention.rel_attention_bwd_kernel.launches == 0\n"
        "assert rel_attention.rel_attention_bias_bwd_kernel.launches == 0\n"
        "assert rel_attention.rel_attention_kernel.launches == 0\n"
        "assert fused_tail.fused_resblock_trio_kernel.launches == 0\n"
        "assert rel_attention.rel_attention_bias_kernel.launches == 0\n"
        "assert attention.attention_kernel.launches == 0\n"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
