"""GigaSpeech / TED-LIUM KD trainer CLI of the port (reference
asr_train_GS.py:1453-1972: --train_student_model; the corpus follows
--data_script_path).

    python -m tpu_asr_torch.cli.asr_train_GS --help
"""

from tpu_asr_torch.cli.common import build_train_parser, run_training


def main(argv=None):
    args = build_train_parser(
        "Train Conformer CTC student on GigaSpeech/TED-LIUM",
        gigaspeech=True).parse_args(argv)
    corpus = "tedlium" if "tedlium" in args.data_script_path else "gigaspeech"
    return run_training(args, corpus=corpus)


if __name__ == "__main__":
    main()
