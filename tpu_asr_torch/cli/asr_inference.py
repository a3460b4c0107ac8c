"""LibriSpeech inference/eval CLI of the port (reference
asr_inference.py:205-471): rebuild the model from the teacher config and
the flags, load the checkpoint, WER per split.

    python -m tpu_asr_torch.cli.asr_inference --help

`--gpus N` (cards, NCCL), `--platform cpu --host_devices N` (CPU ranks, gloo)
or torchrun evaluate on N ranks, each on its block of every batch; rank 0
prints the summed results (cli/common.run_inference).
"""

from tpu_asr_torch.cli.common import build_inference_parser, run_inference


def main(argv=None):
    args = build_inference_parser(
        "Evaluate a trained student on LibriSpeech splits").parse_args(argv)
    return run_inference(args)


if __name__ == "__main__":
    main()
