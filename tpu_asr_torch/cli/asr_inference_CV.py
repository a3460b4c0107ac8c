"""CommonVoice (OOD) inference CLI of the port (reference
asr_inference_CV.py:264-514), with its CV flags (--cv_dataset_name,
--cv_lang, --cv_splits, --hf_token; reference :289-294) translated onto
the generic data surface, as tpu_asr's asr_inference_CV.py does.

    python -m tpu_asr_torch.cli.asr_inference_CV --help

`--gpus N` (cards, NCCL), `--platform cpu --host_devices N` (CPU ranks, gloo)
or torchrun evaluate on N ranks, each on its block of every batch; rank 0
prints the summed results (cli/common.run_inference).
"""

from tpu_asr_torch.cli.common import build_inference_parser, run_inference


def main(argv=None):
    parser = build_inference_parser(
        "Evaluate a trained student on CommonVoice (OOD)")
    parser.add_argument(
        "--cv_dataset_name", type=str, default="./commonvoice_asr.py",
        help="HF dataset name or local builder script (reference default "
             "mozilla-foundation/common_voice_7_0)")
    parser.add_argument("--cv_lang", type=str, default="en",
                        help="language code (e.g., en, de, fr, ...)")
    parser.add_argument("--cv_splits", type=str, default="validation,test",
                        help="comma-separated HF splits to evaluate")
    parser.add_argument("--hf_token", type=str, default=None,
                        help="HF token (Common Voice requires auth)")
    parser.set_defaults(eval_data="commonvoice")
    args = parser.parse_args(argv)

    args.data_script_path = args.cv_dataset_name
    args.data_config_name = args.cv_lang
    cv_splits = [s for s in args.cv_splits.split(",") if s]
    args.data_train_split = None                 # inference: no train split
    args.data_val_split = cv_splits[0] if len(cv_splits) > 1 else None
    args.data_test_split = cv_splits[-1]
    return run_inference(args)


if __name__ == "__main__":
    main()
