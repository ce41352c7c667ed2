"""Training for the port: the teacher-forced TTS train step (train.py), its
checkpoints (checkpoint.py), the (dp, tp) / (dp, sp, tp) layout over
torch.distributed (sharding.py), and a CPU multi-process dry run
(dryrun.py). Counterpart of qwen3_tts_tpu/parallel/."""
