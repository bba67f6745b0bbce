from .symbols import SYMBOLS, SYMBOLS_TO_ID, PUNCTUATION, cleaned_text_to_sequence
