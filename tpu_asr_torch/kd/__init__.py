"""Knowledge-distillation modules: noise schedules, losses, meta encoders
and flow matching."""
