from .medley import MedleyPrompt, iter_edit_pairs, load_medley_prompts

__all__ = ["MedleyPrompt", "iter_edit_pairs", "load_medley_prompts"]
