"""Latent AE+FM/diffusion ("diffm") KD trainer CLI of the port (reference
asr_train_diffm.py: --model_version ver1..ver8, --latent_dim).

    python -m tpu_asr_torch.cli.asr_train_diffm --help
"""

from tpu_asr_torch.cli.common import build_train_parser, run_training


def main(argv=None):
    args = build_train_parser(
        "Train Conformer CTC student with latent diffm KD (ver1-8)",
        diffm=True).parse_args(argv)
    return run_training(args, corpus="librispeech",
                        diffm_version=args.model_version)


if __name__ == "__main__":
    main()
