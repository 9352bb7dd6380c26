"""Text-explainer prompt library (functional equivalent of
reference agents/explainers/simple/prompts.py).

Same prompt architecture — a system prompt with optional chain-of-thought /
activation-value / logits sections, plus three few-shot (user, assistant)
example pairs assembled per variant — with the contracts downstream code
depends on preserved exactly:

* activating spans are delimited `<<like this>>` (produced by
  agents/utils.py highlight),
* activation values appear as `Activations: ("tok" : n)` lines,
* promoted-logit lists appear after `Top_logits:`,
* the assistant's final line must start with `[EXPLANATION]:`.

The few-shot example texts themselves are original to this framework.

Copied from multimodal_sae_tpu/agents/explainers/simple/prompts.py; it uses no jax.
"""

### SYSTEM PROMPT ###

SYSTEM = """You are a meticulous AI researcher conducting an important investigation into a certain neuron in a language model. Your task is to analyze the neuron and provide an explanation that thoroughly encapsulates its behavior.
{prompt}
Guidelines:

You will receive text examples on which the neuron fires. Tokens that trigger the neuron are wrapped in delimiters like <<this>>; when several consecutive tokens all trigger it, the whole run is wrapped <<just like this>>. An activation value may be listed after an example in parentheses.

- Keep the final description short and concrete. Describe the textual features the neuron fires on and, if informative, what it predicts next.
- Skip mentioning the text features or the predicted tokens if they carry no signal.
- Your response must end with the formatted explanation line."""

COT = """
(Part 1) Tokens that the neuron activates highly on in text

Step 1: Pick out a handful of activating and nearby context tokens that stand out (at most 5) and look for a pattern among them.
Step 2: Note the broader features the example texts share.
"""

ACTIVATIONS = """
(Part 1) Tokens that the neuron activates highly on in text

Step 1: Pick out a handful of activating and nearby context tokens that stand out and look for a pattern among them.
Step 2: Note the broader features the example texts share.
Step 3: Use the activation values to judge which examples represent the neuron best.
"""

LOGITS = """
(Part 2) Tokens that the neuron boosts in the next token prediction

You will also see a list named Top_logits: the tokens this neuron pushes up in the model's next-token prediction. These can reveal what the neuron's activation does to the output — sometimes more clearly than the activating examples. Find what the Top_logits words share, reconcile that with your Part 1 observations, and give one combined explanation of what makes the neuron fire. Use this format:
[EXPLANATION]: <your explanation>
"""

### EXAMPLE 1 — unit-of-measurement contexts ###

EXAMPLE_1 = """
Example 1:  the recipe calls for two <<cups>> of flour and a
Example 2:  runners covered nearly forty <<miles>> before the first checkpoint
Example 3:  the tank holds fifty <<liters>>, which lasts about a week
"""

EXAMPLE_1_ACTIVATIONS = """
Example 1:  the recipe calls for two <<cups>> of flour and a
Activations: ("cups", 8)
Example 2:  runners covered nearly forty <<miles>> before the first checkpoint
Activations: ("miles", 7)
Example 3:  the tank holds fifty <<liters>>, which lasts about a week
Activations: ("liters", 9)
"""

EXAMPLE_1_LOGITS = """
Top_logits: ["gallons", "kilometers", "pounds", "acres", "ounces"]
"""

EXAMPLE_1_COT_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "cups", "miles", "liters".
PREVIOUS TOKENS: "two", "forty", "fifty".

Step 1.
Every activating token is a unit of measurement.
Every preceding token is a number.

Step 2.
- The examples quantify something concrete (ingredients, distance, volume).
- The unit always directly follows a numeral.
"""

EXAMPLE_1_COT_ACTIVATION_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "cups", "miles", "liters".
PREVIOUS TOKENS: "two", "forty", "fifty".

Step 1.
Every activating token is a unit of measurement.
Every preceding token is a number.

Step 2.
- The examples quantify something concrete (ingredients, distance, volume).
- The unit always directly follows a numeral.

Step 3.
- The activations are uniformly high (7-9), so all three examples are representative.
"""

EXAMPLE_1_LOGITS_RESPONSE = """
(Part 2)
SIMILAR TOKENS: all promoted tokens are also units of measurement.
The neuron both fires on and predicts measurement units after quantities.
"""

EXAMPLE_1_EXPLANATION = """
[EXPLANATION]: Units of measurement immediately following a numeral.
"""

### EXAMPLE 2 — apologetic/hedging verbs ###

EXAMPLE_2 = """
Example 1:  I must <<apologize>> for the delay in responding to
Example 2:  we sincerely <<regret>> any inconvenience this may have caused
Example 3:  she wanted to <<excuse>> herself from the meeting early
"""

EXAMPLE_2_ACTIVATIONS = """
Example 1:  I must <<apologize>> for the delay in responding to
Activations: ("apologize", 9)
Example 2:  we sincerely <<regret>> any inconvenience this may have caused
Activations: ("regret", 8)
Example 3:  she wanted to <<excuse>> herself from the meeting early
Activations: ("excuse", 4)
"""

EXAMPLE_2_LOGITS = """
Top_logits: ["sorry", "apologies", "forgive", "pardon", "deeply"]
"""

EXAMPLE_2_COT_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "apologize", "regret", "excuse".
PREVIOUS TOKENS: "must", "sincerely", "to".

Step 1.
The activating tokens are verbs of apology or contrition.
The previous tokens include intensifiers common in formal apologies.

Step 2.
- The examples are polite, formal expressions of regret.
"""

EXAMPLE_2_COT_ACTIVATION_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "apologize", "regret", "excuse".
PREVIOUS TOKENS: "must", "sincerely", "to".

Step 1.
The activating tokens are verbs of apology or contrition.
The previous tokens include intensifiers common in formal apologies.

Step 2.
- The examples are polite, formal expressions of regret.

Step 3.
- "apologize" and "regret" activate much higher than "excuse", so direct apology verbs are most representative.
"""

EXAMPLE_2_LOGITS_RESPONSE = """
(Part 2)
SIMILAR TOKENS: the promoted tokens continue apologetic phrasing.
The neuron fires on apology verbs and promotes apology-related continuations.
"""

EXAMPLE_2_EXPLANATION = """
[EXPLANATION]: Verbs of apology or regret in polite, formal statements.
"""

### EXAMPLE 3 — C-family source code keywords ###

EXAMPLE_3 = """
Example 1:  <<static>> int counter = 0; <<void>> reset
Example 2:  returns a <<const>> reference to the underlying buffer
Example 3:  declared the method <<virtual>> so subclasses could override it
"""

EXAMPLE_3_ACTIVATIONS = """
Example 1:  <<static>> int counter = 0; <<void>> reset
Activations: ("static", 10), ("void", 9)
Example 2:  returns a <<const>> reference to the underlying buffer
Activations: ("const", 7)
Example 3:  declared the method <<virtual>> so subclasses could override it
Activations: ("virtual", 6)
"""

EXAMPLE_3_LOGITS = """
Top_logits: ["inline", "unsigned", "extern", "int", "char"]
"""

EXAMPLE_3_COT_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "static", "void", "const", "virtual".
PREVIOUS TOKENS: No consistent pattern.

Step 1.
All activating tokens are C/C++ declaration keywords.

Step 2.
- The examples are program source or prose describing code.
- The keywords modify declarations of functions or variables.
"""

EXAMPLE_3_COT_ACTIVATION_RESPONSE = """
(Part 1)
ACTIVATING TOKENS: "static", "void", "const", "virtual".
PREVIOUS TOKENS: No consistent pattern.

Step 1.
All activating tokens are C/C++ declaration keywords.

Step 2.
- The examples are program source or prose describing code.
- The keywords modify declarations of functions or variables.

Step 3.
- Activation is highest inside literal code ("static", 10) and lower in prose about code ("virtual", 6).
"""

EXAMPLE_3_LOGITS_RESPONSE = """
(Part 2)
SIMILAR TOKENS: the promoted tokens are further C-family type and storage keywords.
The neuron fires on declaration keywords and predicts more of them.
"""

EXAMPLE_3_EXPLANATION = """
[EXPLANATION]: C-family declaration keywords (static, const, void, virtual) in code or code-adjacent text.
"""


def get(item):
    return globals()[item]


def _prompt(n, logits=False, activations=False, **kwargs):
    starter = get(f"EXAMPLE_{n}") if not activations else get(f"EXAMPLE_{n}_ACTIVATIONS")
    prompt_atoms = [starter]
    if logits:
        prompt_atoms.append(get(f"EXAMPLE_{n}_LOGITS"))
    return "".join(prompt_atoms)


def _response(n, cot=False, logits=False, activations=False):
    response_atoms = []
    if cot and activations:
        response_atoms.append(get(f"EXAMPLE_{n}_COT_ACTIVATION_RESPONSE"))
    elif cot:
        response_atoms.append(get(f"EXAMPLE_{n}_COT_RESPONSE"))
    if logits:
        response_atoms.append(get(f"EXAMPLE_{n}_LOGITS_RESPONSE"))
    response_atoms.append(get(f"EXAMPLE_{n}_EXPLANATION"))
    return "".join(response_atoms)


def example(n, **kwargs):
    return _prompt(n, **kwargs), _response(n, **kwargs)


def system(cot=False, logits=False, activations=False):
    prompt = ""
    if cot and activations:
        prompt += ACTIVATIONS
    elif cot:
        prompt += COT
    if logits:
        prompt += LOGITS
    return [{"role": "system", "content": SYSTEM.format(prompt=prompt)}]
