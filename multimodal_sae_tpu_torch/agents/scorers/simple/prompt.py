"""Detection-scoring prompt (functional equivalent of
reference agents/scorers/simple/prompt.py).

Contract preserved: the judge sees an explanation plus examples whose
candidate spans are wrapped in << >>, and must reply with nothing but a
Python list of integers in [0, 3] — one per example — per the same rubric
(0 irrelevant ... 3 cleanly identifies).  Few-shot texts are original.

Copied from multimodal_sae_tpu/agents/scorers/simple/prompt.py; it uses no jax.
"""

DSCORER_SYSTEM_PROMPT = """You are an intelligent and meticulous linguistics researcher.

You will be given a feature of text, such as "male pronouns" or "text with negative sentiment", followed by several text examples claimed to contain that feature. The portions of each example that supposedly express the feature are wrapped between << and >>.

Some examples may be mislabeled. Judge, for each example independently, how well the marked tokens actually express the stated feature: every example could be correct, none could be, or any mix. An example only deserves full credit when every marked token genuinely represents the feature.

Score each example in order using this rubric:

########## RUBRICS ##########

0 - The feature is completely irrelevant throughout the context (relative to the base distribution of the internet).
1 - The feature is related to the context, but not near the highlighted text or only vaguely related.
2 - The feature is only loosely related to the highlighted text or related to the context near the highlighted text.
3 - The feature cleanly identifies the activating text.

########## OUTPUT REQUIREMENTS ##########

Reply with a valid Python list and nothing else. Every element must be an integer from 0 to 3. If none of the examples show the feature, output 0 for each without explanation. Follow the rubric and the output requirement strictly; output nothing besides the Python list of integers.
"""

DSCORER_EXAMPLE_ONE = """Feature explanation: Units of measurement immediately following a numeral.

Text examples:

Example 0: the bridge spans nearly two hundred <<meters>> across the gorge
Example 1: she counted <<seventeen>> swans gliding over the lake at dawn
Example 2: add three <<cups>> of broth and simmer for ten <<minutes>>
Example 3: the report was <<due>> on Friday but arrived a week late
Example 4: engines producing over a thousand <<horsepower>> are now common
"""

DSCORER_RESPONSE_ONE = "[3, 1, 3, 0, 3]"

DSCORER_EXAMPLE_TWO = """Feature explanation: Verbs of apology or regret in polite, formal statements.

Text examples:

Example 0: we deeply <<regret>> the confusion caused by the earlier notice
Example 1: the committee decided to <<postpone>> the vote until spring
Example 2: I must <<apologize>> for interrupting your presentation yesterday
Example 3: he shrugged and <<walked>> away without a word
Example 4: please accept our sincere <<thanks>> for your patience
"""

DSCORER_RESPONSE_TWO = "[3, 0, 3, 0, 1]"

DSCORER_EXAMPLE_THREE = """Feature explanation: C-family declaration keywords in source code.

Text examples:

Example 0: declare the buffer <<static>> so it persists between calls
Example 1: the recipe says to <<fold>> the egg whites in gently
Example 2: mark the accessor <<const>> and return a <<reference>>
Example 3: use an <<unsigned>> integer for the loop counter here
Example 4: the <<weather>> turned cold before the harvest finished
"""

DSCORER_RESPONSE_THREE = "[3, 0, 2, 3, 0]"


def prompt(examples: str, explanation: str):
    """Assemble the judge messages (reference prompt.py:100-116)."""
    user_start = f"Feature explanation: {explanation}\n\nText examples:\n\n{examples}"
    return [
        {"role": "system", "content": DSCORER_SYSTEM_PROMPT},
        {"role": "user", "content": DSCORER_EXAMPLE_ONE},
        {"role": "assistant", "content": DSCORER_RESPONSE_ONE},
        {"role": "user", "content": DSCORER_EXAMPLE_TWO},
        {"role": "assistant", "content": DSCORER_RESPONSE_TWO},
        {"role": "user", "content": DSCORER_EXAMPLE_THREE},
        {"role": "assistant", "content": DSCORER_RESPONSE_THREE},
        {"role": "user", "content": user_start},
    ]
