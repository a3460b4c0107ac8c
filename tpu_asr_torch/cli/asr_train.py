"""LibriSpeech KD trainer CLI of the port (reference asr_train.py:1379-1893,
the flag surface of tpu_asr's asr_train.py).

    python -m tpu_asr_torch.cli.asr_train --help
"""

from tpu_asr_torch.cli.common import build_train_parser, run_training


def main(argv=None):
    args = build_train_parser(
        "Train halved-dimension Conformer CTC student on LibriSpeech"
    ).parse_args(argv)
    return run_training(args, corpus="librispeech")


if __name__ == "__main__":
    main()
