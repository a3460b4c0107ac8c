"""diffm inference CLI of the port (reference asr_inference_diffm.py:
506-525: --model_ver 1..8, --eval_data).

    python -m tpu_asr_torch.cli.asr_inference_diffm --help

`--gpus N` (cards, NCCL), `--platform cpu --host_devices N` (CPU ranks, gloo)
or torchrun evaluate on N ranks, each on its block of every batch; rank 0
prints the summed results (cli/common.run_inference).
"""

from tpu_asr_torch.cli.common import build_inference_parser, run_inference


def main(argv=None):
    args = build_inference_parser(
        "Evaluate a diffm-trained student", diffm=True).parse_args(argv)
    return run_inference(args, diffm_version=args.model_ver)


if __name__ == "__main__":
    main()
