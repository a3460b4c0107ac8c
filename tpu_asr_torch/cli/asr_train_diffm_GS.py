"""diffm KD trainer on GigaSpeech/TED of the port (reference
asr_train_diffm_GS.py).

    python -m tpu_asr_torch.cli.asr_train_diffm_GS --help
"""

from tpu_asr_torch.cli.common import build_train_parser, run_training


def main(argv=None):
    args = build_train_parser(
        "Train Conformer CTC student with diffm KD on GigaSpeech/TED",
        gigaspeech=True, diffm=True).parse_args(argv)
    corpus = "tedlium" if "tedlium" in args.data_script_path else "gigaspeech"
    return run_training(args, corpus=corpus,
                        diffm_version=args.model_version)


if __name__ == "__main__":
    main()
